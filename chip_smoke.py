#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (krakenuniq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # the whole check
    python3 chip_smoke.py --kernels-only DIR    # phases 1-2 on DIR's package
    python3 chip_smoke.py --ooc-only DIR        # phase 8's chunk passes, DIR's package
    python3 chip_smoke.py --fallback-only DIR   # phases 9's and 10's spans, DIR's package
    python3 chip_smoke.py --uid-ooc-only DIR    # phase 13's span and raw chunk passes, DIR's package

`--kernels-only` imports krakenuniq_tpu_torch from DIR (a checkout, or an
unpacked `git archive` of one), builds its kernels there and runs phases 1
and 2 only: run on two checkouts in turns (A, B, B, A) in one call, it
times both packages' kernels on the same inputs and the same card.
`--ooc-only` does the same for the out-of-core chunk passes: phase 1, then
phase 4's database and reads (built on the first run of a call, reused by
the next) streamed through the card by DIR's package at PRELOAD_SIZE,
its passes measured as phase 8 measures them (one JSON line).
`--fallback-only` does the same for the fallback lookups: phase 1, then
phase 4's database loaded by DIR's package under each forced fallback, the
binary search's bins and search and the fused probe timed on the first span
(one JSON line). `--uid-ooc-only` does the same for the UID probes: phase
1, then phase 4's database with phase 13's UID values (built on the first
run of a call, reused by the next) loaded by DIR's package, rows_probe on
the first span of phase 13's reads, then those reads' spans through the
raw chunk tables out of core at PRELOAD_SIZE, each chunk pass measured
(one JSON line; on a package with them, the raw probe's designs of
tools/kernel_variants on the same span and chunk).

Phases, each raising on failure:
  1. card and build: the card's name and power limit; build every kernel of
     csrc/ from source (one nvcc per file, in parallel) and the port's
     native host module (kuniq_native_torch, one C++ compile);
  2. each kernel against its plain PyTorch version on the card, integer for
     integer (tolerance 0: every output is an integer or a bool), at the
     span and unit shapes and the shapes of the JAX package's kernel tools,
     with scores' edge rows (all-miss, all-hit, W = 1025 and 2018, a
     tout < tin hit in every row), kmer_front's (k = 21, LB = 161, rows
     of length 0, k - 1 and k), chd_probe on random planes of the phase-4
     table's size (1.14 GB, no database build: 8.5M uniform queries and a
     zipf unit), hll_regmax's (one hot slot, one hot row, pre-filled
     registers, p = 4 and 18, every flagged stored value) and taxon_counts'
     (both counts of a unit in one launch, over the 503-id pool, over the
     dense 2.4M-id space with zipf-skewed ids and over 58,112 and 58,113
     ids, the edge of its shared-memory form), pack_runs in its three row
     layouts and with the fused HLL feed (`compact+hll`; on a package
     without the feed, its kernel plus the torch ops that built the feed,
     timed over every card record of a call) and the packed-input
     kmer_front at the unit and span shapes (reads that overflow the run
     slots, ambiguous runs, reads shorter than k, quick-mode feed cuts),
     pack_runs on a ragged [65535, 130] and on row-sliced planes off the
     16-byte grid, sparse_stats and its key build sparse_keys (the unit,
     the span with 17 units over pool and dense ids, one giant group, a
     stayed-sparse group of many duplicates across several tiles, a span
     with no counted lane, the d == m/4 edge with and without a last
     duplicate, a cap below the entry count), span_dict (the span over the
     2.4M-id space, T not a multiple of 32, with n_u below, at and above
     its capacity, ids 0, 31, 32 and T - 1, ids outside [0, T), and 0
     with the top 400 ids, which cluster in few bitmap words) and
     taxon_counts and hll_regmax at the span's lanes (pool, and dense ids
     through a lut); each check times the wrapper call (`ms`, CUDA events,
     host launch path included) and the kernel alone (`device_ms`,
     torch.profiler, summed over a call's launches and over the card
     records of a launch, RECORDS_PER_LAUNCH of the package under test),
     each sparse_stats check also the whole wrapper call's card time
     (`call_device_ms`: key build, sort and stats), and each chd_probe
     check the one-level random-row floor (`floor_ms`); and the fallback
     lookups' kernels: fused_probe on random fused planes of the phase-4
     table's size (lb = 27) and at lb = 30, half the queries planted,
     kmer_bins at the unit and span shapes on both feeds at k = 21 / nt = 7
     and k = 31 / nt = 12, 15, 31 and 20, bsearch_lookup with out-of-range bins,
     invalid lanes, empty bins and bin_start 0 and 12,345, and bsearch_words
     (the packed feed's search) on random sorted planes made from the span's
     own lanes, with bins of 0, 1, 31, 32, 63, 64, 65, 300, 511 and 512 keys,
     n_iter 10 and 5, bin_start 0 and a shard from 12,345, a later
     database's pass, and rows of 8,192 bases at nt = 12 and 20; and the
     long-read step's rows [8, 32768]: kmer_front on both entries with and
     without its canon plane (also with it at the span shape), chd_probe on
     those rows' hashes over random planes of the phase-4 table's size,
     chd_probe_acc and bsearch_words on such rows; and the raw two-level
     (UID) table's kernels: rows_probe on its edge cases (coinciding
     buckets, zero tags behind an empty slot, a false screen in the first
     bucket), on random planes of phase 13's size (lb = 27, 3.2 GB: 8.5M
     queries, half planted) and at the long-read rows, and rows_probe_acc
     on a random raw chunk of phase 8's width (lb = 23) with half the words
     set, at [4096, 160] and the span shape [65536, 160], each with its
     floor_ms on the confirm plane, the split of its lanes (screened in
     the first bucket, the second, neither) and, for rows_probe, floor_mix_ms
     (the random-sector floor of the sectors that split needs);
  3. the golden fixture on the card: Classifier(device="cuda") reproduces the
     reference binaries' kraken output and report byte for byte, for the
     single database and for the hierarchical db_bact + db_viral pair,
     through the span route, the Python host route and --device-counters
     on both; the UID golden (kraken_uid.out, Classifier(...,
     uid_database=True)) on those four and out of core at a quarter of its
     raw table; then the same eight runs through each fallback lookup, on
     copies of the golden databases with the table build made to fail:
     CHD placement (the fused layout, fused_probe) and the whole table
     build (the binary search: bsearch_words on the span route, kmer_bins
     and bsearch_lookup on the Python route);
  4. the main path at full size, on the span route: a synthetic database
     at the JAX bench's default shape (400 species x 25 kbp, BALLAST = 101M
     ballast keys, a 2.4M-node taxonomy, k=31, nt=12) under
     krakenuniq_tpu_torch/_build/ (synthesised with the reads in a child
     process while phases 2 and 3 run), loaded by Classifier(device="cuda")
     with the port's table caches removed first (a cold build, which
     writes `database.kdb.ht_torch`; phase 14 checks a warm load, on the
     database it builds), classifying the JAX bench's N_READS = 1M zipf-1.5 150 bp reads
     through Classifier.run and write_report with every launch counter reset
     just before and read just after; the calls are checked against each
     read's true species, one full span is held against the same step
     forced to the plain versions, each kernel (pack_runs also in the fused
     form the step launches, equal to the step's rows and feed) is timed on
     that span's inputs, and one span step's card time is split by
     operation (`span_step_device_ms_by_op`: busy and first-to-last ms, the
     idle share between them, the top 8 records by time);
  5. --device-counters on the span route on the same loaded database:
     Classifier.with_shared_db(..., device_counters=True) classifies the
     same reads with every launch counter reset just before and read just
     after; its kraken output and report must be byte-equal to phase 4's,
     with sparse_stats, taxon_counts, hll_regmax, pack_runs (no HLL feed),
     kmer_front, chd_probe and scores launched once per span, no
     Python-route unit and no sparse-buffer overflow; one span's step
     with the update is held against the same forced to the plain
     versions, and the three counter kernels are timed on that span's
     planes;
  5b. --device-counters on the Python host route (use_native=False) on the
     first 200,000 of the reads (a cut that keeps the script within its
     time limit), byte-equal to phase 4's configuration on the same reads
     and to phase 4's lines for them (so the routes agree at full size),
     the counter kernels launched once per work unit; one unit's update
     against the plain update;
  6. the random row-fetch probe (krakenuniq_tpu_torch.tools.probe_gather):
     the sweep over copies in flight at 16- and 512-byte rows, with the
     launch counters reset just before and read just after;
  7. value_pool=False on the database phase 14 builds (9,988,000 keys, phase
     4's genome keys: a cut of scale for the time limit, as four cold loads
     of phase 4's 111M keys take ~300 s; --fallback-only and --ooc-only
     load those), one reload, its `.ht_dense_torch` cache removed first (a cold dense
     build): dense ids over the 2.4M-node taxonomy on the span route with
     the per-span taxon dictionary (span_dict once per span), byte-equal to
     phase 14's run of phase 4's reads on that database (whose kraken
     output is phase 4's; the reference of phases 7-10 and 8); one
     span step against the plain one, its card time by operation, span_dict
     on its planes; then on the first 100,000 reads a dictionary of 64 ids
     (every span redispatched on the wide rows) and --device-counters under
     the dictionary, both byte-equal to the default-capacity run;
  9. the binary-search fallback: the built database loaded with the table
     build made to fail (caches removed first), its sorted planes on the
     card (keys, vals, vals_dense, offsets), dense ids under the span
     dictionary; phase 4's reads byte-equal to the reference,
     bsearch_words once a span (kmer_bins and bsearch_lookup never), one
     span step against the plain one, bsearch_words on that span's feed and
     the real planes, beside the unpacked feed's pair kmer_bins and
     bsearch_lookup on the same span (bsearch_lookup with its random-sector
     floor of 2 + n_iter reads);
  10. the fused fallback: the built database loaded with CHD placement
     made to fail (caches removed before and after the load), the fused
     two-choice layout over pool ids; phase 4's reads byte-equal to the
     reference, fused_probe once a span and chd_probe
     never, one span step against the plain one, and fused_probe on that
     span's hashes and the real plane, with the valid lanes answered by
     their first row, by their second and missed, the two-row and one-row
     random-sector floors and the mix of them those shares give;
  11. long reads on phase 4's loaded database (with_shared_db): phase 4's
     first 100,000 reads with 500 reads of 33-100 kbp among them (zipf-1.5
     species, each read from its genome as a circle from a random offset);
     the short reads' lines byte-equal to phase 4's, each long read's hit
     list L - k + 1 k-mers long and equal, k-mer by k-mer, to its chunks'
     classified as ordinary reads on the span route, its call its species;
     a --device-counters run byte-equal; kmer_front and chd_probe once a
     long read and scores only in the short reads' steps; long reads/s,
     Mbp/s, ms a long read and one long-read step's card time by operation;
  12. --exact on phase 4's loaded database: phase 4's first 200,000 reads
     on the span route (a cut that keeps the script within its time limit),
     the kraken output byte-equal to phase 4's configuration on the same
     reads (phase 5b's reference run) and the report equal outside kmers,
     dup and cov; the same reads with --device-counters (counts only on the
     card) byte-equal, output and report;
  8. out of core on the built database (one reload with preload_size =
     PRELOAD_SIZE_BUILT, 64 MiB, its `.htc_torch` cache removed
     first; the warm reload from that cache runs on a copy of the golden
     database at 64 KiB, cold then warm, bit-equal): the database cut into at least
     4 chunk tables, two of which fit the budget, streamed through the card
     on the copy stream. The default options on phase 4's reads,
     byte-equal to the reference, with chd_probe_acc launched spans x chunks
     times, kmer_front once a span (the chunk passes compute their own
     k-mer front; only the finish step launches it), chd_probe never,
     scores and pack_runs once a span; Classifier.with_shared_db(...,
     device_counters=True, ooc_group_bytes=256 MiB) (several groups),
     byte-equal to the reference; single-buffered on the first 200,000
     reads, byte-equal to its lines for them; the run's spans probed as one
     group double- and single-buffered in turns (the share of the copies
     hidden behind the probes, the first and the later chunk passes' ms),
     chd_probe_acc's card time summed over the group's whole chunk
     sequence, the lanes each chunk pass probes of the first span (their
     sum at most its searched lanes); chd_probe_acc against its plain
     version on the chunk holding most of a span's hits, with a seeded half
     of the span's merged words already set, beside floor_ms (row_gather
     over as many random rows of that chunk's row plane as it probes), and
     one `ooc` line (budget, chunks, load split, reads/s, host s a span by
     stage, copy and probe ms a chunk, the hidden share, peak memory); then
     50 of phase 11's long reads out of core, byte-equal to phase 11's lines;
  13. UID databases: a UID database over phase 4's 9,988,000 genome keys
     (written by the synthesis process beside phase 4's directory, with
     phase 4's index cut to them: 400 singleton UIDs and 10,000 of 2-4
     species chained as the UID build chains them; genome keys take their
     species' UID, 5% of them a set holding it; a cut of scale for the time
     limit: --uid-ooc-only loads the 3.2 GB table of all 111M keys), loaded cold
     with Classifier(..., uid_database=True) (201 MB of raw planes); phase
     4's first 200,000 reads on the span route, 99%
     called as their species, rows_probe once a span and chd_probe never;
     --device-counters byte-equal; the first 20,000 reads on the Python
     route byte-equal to the span route's lines; 20 of phase 11's long
     reads each called as its species; one span step against the plain
     one, rows_probe on that span's hashes and the real planes; one `uid`
     line (reads/s, host s a span with the UID resolve alone, card s a
     span, the load split, peak memory);
  14. the build and the host tools: phase 4's 400 genomes (a library of
     10.0 Mbp, one line a genome) and its 2,400,503-node taxonomy (NCBI
     dumps), both written by the second synthesis process, built by the
     port's build CLI (build_main --kmer-len 31 --minimizer-len 12
     --uid-database): each step's seconds, the LCA build's keys/s and peak
     RSS, step 6b on the card with every launch counter reset just before
     it (kmer_front, chd_probe, scores and pack_runs launched); the built
     kdb equal to phase 4's genome keys and species, its taxDB to phase
     4's, every library sequence called as its species; phase 4's reads
     on step 6b's tables, byte-equal to phase 4 (the reference of phases
     7-10 and 8, which follow on this database); the accuracy loop
     (simulate_and_grade: N_SIM_READS reads of 150 bp at SIM_ERROR
     substitutions, a warm load of step 6b's cached table) in a child
     process beside the build, within tests/test_simulated_accuracy.py's
     bounds, and its reads against the built UID database, the same calls;
     count-unique on the library; report, translate (plain and
     --mpa-format), mpa-report, filter and extract-reads on phase 4's
     outputs, in a child process beside phases 5-13; one `tools` line.
Phases run in the order 1-5, 5b, 11, 12, 13, 14, 7, 9, 10, 8, 6; phases 13,
7, 9, 10 and 8 parse the 2.4M-node taxonomy once between them
(shared_taxonomy). Progress goes to stderr; stdout carries one JSON line per
kernel check, the fallback and UID goldens' lines, the summaries of phases 4,
5, 5b, 11, 12, 13, 14, 7, 9, 10 and 8,
one line per probe setting, the kernel table, the card line and, last, the
device line.
Exits non-zero without a result when no CUDA device (or no port) is present.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "data")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Every kernel here does integer work (compares, shifts, adds), which issues
# at 64 per SM per clock on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 132 SMs x 64 x 1.98 GHz boost.
INT_OPS_PER_S = 132 * 64 * 1.98e9

# Phase 4: the JAX bench's default database (bench.py:225-230) and reads
# (bench.py:234).
N_SPECIES, GENOME_LEN, PAD_NODES, BALLAST = 400, 25_000, 2_400_000, 101_000_000
N_READS = 1_000_000
# Phase 8: the out-of-core budget (--preload-size 64M on phase 14's built
# database of 10M keys: 4 or more chunk tables, two at a time on the card; 512M
# on phase 4's, which --ooc-only and --uid-ooc-only load), the group budget of
# its device-counters run and the reads of its single-buffered run
PRELOAD_SIZE_BUILT = 64 << 20
PRELOAD_SIZE = 512 << 20
OOC_GROUP_BYTES = 256 << 20
N_READS_SINGLE = 200_000
# Long rows for phase 2: [64, LONG_LB], rows cut into tiles. (k, nt) = (31,
# 12) and (31, 20) take the 4- and 8-byte values; at (21, 20) and (17, 16),
# w = 2, a tile's values pass 48 KB and the plan halves the tile.
LONG_LB = 8192
LONG_LENGTHS = (8192, 8100, 6000, 4200, 150, 10)
LONG_KNT = ((31, 12), (31, 20), (21, 20), (17, 16))
# The long-read step's rows for phase 2: [8, LONG_READ_LB], the default
# max_read_len (a long read's chunk), full and partial chunks, a read's last
# chunk of k bases and rows shorter than k.
LONG_READ_LB = 1 << 15
LONG_READ_LENGTHS = (32768, 32768, 32700, 20000, 5000, 31, 30, 0)
# Phase 11: phase 4's first N_LONG_SHORT reads with N_LONG long reads of
# 33-100 kbp among them, N_LONG_OOC of which phase 8 runs out of core.
# Phase 12: --exact on phase 4's first N_READS_SINGLE reads, with and
# without device counters.
N_LONG_SHORT, N_LONG, N_LONG_OOC = 100_000, 500, 50
LONG_MIN, LONG_MAX = 33_000, 100_000
# Phase 13: a UID database over phase 4's keys (400 singleton UIDs, one a
# species, and N_UID_SETS UIDs of 2-4 species; UID_SET_SHARE of the genome
# keys take a set holding their species), phase 4's first N_READS_UID reads
# on the span route, the first N_READS_UID_PY of them on the Python route and
# N_LONG_UID of phase 11's long reads
N_UID_SETS, UID_SET_SHARE = 10_000, 0.05
N_READS_UID, N_READS_UID_PY, N_LONG_UID = 200_000, 20_000, 20
# Phase 14: the accuracy loop's simulated reads (150 bp, 2% substitutions)
N_SIM_READS, SIM_ERROR = 200_000, 0.02

T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of fn() over `reps` CUDA-event pairs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# the CUDA kernel symbol of each wrapper (a substring of the profiler's name)
SYMBOLS = {
    "scores": ("scores_kernel",),
    "kmer_front": ("kmer_front_kernel", "kmer_front_packed_kernel"),
    "chd_probe": ("chd_probe_kernel",),
    "chd_probe_acc": ("chd_probe_acc_kernel",),
    "taxon_counts": ("counts_smem_kernel", "counts_global_kernel"),
    "hll_regmax": ("hll_regmax_kernel",),
    "row_gather": ("row_gather_kernel",),
    "pack_runs": ("pack_runs_kernel",),
    "sparse_stats": ("sparse_stats_",),
    "sparse_keys": ("sparse_keys_",),
    # span_dict clears its bitmap with a memset on the stream
    "span_dict": ("span_dict_", "Memset"),
    "fused_probe": ("fused_probe_kernel",),
    "kmer_bins": ("kmer_bins_kernel",),
    "bsearch_lookup": ("bsearch_lookup_kernel",),
    "bsearch_words": ("bsearch_words_kernel",),
    "rows_probe": ("rows_probe_kernel",),
    # the out-of-core pass's instance over the raw table (the CHD one names
    # ChdTable)
    "rows_probe_acc": ("RawTable",),
}


def records_per_launch(kname: str) -> int:
    """Card records of one launch of an entry point that runs several
    kernels in order (one launch is one call of the entry point), as the
    package under test declares them; an older package, without the
    table, ran six for sparse_stats and for span_dict."""
    from krakenuniq_tpu_torch import _kernels

    table = getattr(_kernels, "RECORDS_PER_LAUNCH", {"sparse_stats": 6, "span_dict": 6})
    return table.get(kname, 1)


# Idle seconds kept before and after the timed calls of one profiler
# session, one entry per session tried. The profiler keeps only the kernel
# records that its clock places inside the session, and late in a long
# process the card's timestamps can drift from the host's by more than the
# first margin, so a session that lost records is run again with a wider one.
PROFILE_MARGINS_S = (0.01, 0.25, 2.0)


def queued_ms(fn, reps: int) -> float:
    """Card milliseconds per call of fn() between two CUDA events, with the
    stream held by a spin kernel while the host queues all `reps` calls, so
    the card runs them back to back: fn()'s whole card work without the
    host's launch path (every kernel fn() launches, not one alone)."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning at the card's clock
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_ms(fn, kname: str, reps: int, per_call: int = 1, symbols=None) -> tuple[float, str]:
    """Median card milliseconds of kernel `kname` itself per call of fn(),
    over `reps` calls under torch.profiler: the kernel's own duration on
    the card, without the wrapper's host work or the other kernels fn()
    launches; a call that launches the kernel `per_call` times counts the
    sum of its launches (`symbols` overrides SYMBOLS[kname]: ("",) counts
    every card record). A session that lost kernel records is run again
    with a wider margin (PROFILE_MARGINS_S); when every session lost some,
    the time is queued_ms's. Returns the time and where it came from,
    "profiler" or "events"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    symbols = SYMBOLS[kname] if symbols is None else symbols
    fn()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        evs = sorted((e for e in prof.events()
                      if e.device_type.name == "CUDA" and any(sym in e.name for sym in symbols)),
                     key=lambda e: e.time_range.start)
        if len(evs) == reps * per_call:
            durs = [e.device_time_total for e in evs]
            return statistics.median(
                sum(durs[i:i + per_call]) for i in range(0, len(durs), per_call)) / 1e3, "profiler"
        n_card = sum(e.device_type.name == "CUDA" for e in prof.events())
        log(f"profiler saw {len(evs)} {kname} kernels ({n_card} card records) in {reps} calls "
            f"of {per_call} launches, margin {margin} s")
    return queued_ms(fn, reps), "events"


def device_ms_by_op(fn, reps: int, top: int = 8) -> dict:
    """Where one call of fn() spends its card time: every card record
    (kernels, copies, sets) of `reps` calls, each call followed by a
    synchronize, under torch.profiler with device_ms's idle margins (a
    session whose record counts are not the same for every call is run
    again with a wider margin). Per call: `busy_ms`, the records' summed
    durations; `span_ms`, the median time from a call's first record's
    start to its last record's end, so `idle_share` = 1 - busy/span; and
    the `top` record names by summed time (`ms`, `count` per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
            time.sleep(margin)
        evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        names: dict = {}
        for e in evs:
            names.setdefault(e.name, []).append(e.device_time_total)
        if not evs or len(evs) % reps or any(len(d) % reps for d in names.values()):
            log(f"profiler saw {len(evs)} card records in {reps} calls, margin {margin} s")
            continue
        n = len(evs) // reps
        spans = [(max(e.time_range.end for e in evs[i:i + n]) - min(e.time_range.start for e in evs[i:i + n]))
                 for i in range(0, len(evs), n)]
        busy = sum(e.device_time_total for e in evs) / reps / 1e3
        span = statistics.median(spans) / 1e3
        ops = sorted(((sum(d) / reps / 1e3, len(d) // reps, name) for name, d in names.items()), reverse=True)
        return {
            "busy_ms": busy, "span_ms": span, "idle_share": 1 - busy / span if span > 0 else None,
            "records_per_call": n, "by": "profiler",
            "top": [{"op": name[:96], "ms": ms, "count": cnt} for ms, cnt, name in ops[:top]],
        }
    return {"by": "lost", "busy_ms": None, "span_ms": None, "idle_share": None, "top": []}


def max_abs_err(got, want) -> float:
    """0.0 when every tensor pair is equal, else the largest difference."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()), 1.0)
    return err


def card_records(fn) -> int | None:
    """The card records (kernels, copies) of one call of fn(): the count of
    the first profiler session, over device_ms's idle margins, that kept
    any; None when every session lost them all (late in a long process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        n = sum(e.device_type.name == "CUDA" for e in prof.events())
        if n:
            return n
    log("the profiler kept no card record of a call in any session")
    return None


def check_kernel(name, shape, kernel, plain, reps, bound=None, library=None, extra=None, every_op=False):
    """Run the kernel and its plain version on the same inputs, require
    equality, time both (and `library`, one PyTorch call computing the same
    function, where there is one); returns the record. `ms` is the wrapper
    call between CUDA events (host launch path included), `device_ms` the
    kernel's own card time per call (`device_ms`, summed over the call's
    launches, `launches_per_call`; with `every_op`, over every card record
    of the call, `records_per_call`; `device_ms_by` says whether the
    profiler or queued_ms gave it). `launches` counts this check's
    launches of the kernel (the run, warm-up and timed calls)."""
    import torch

    from krakenuniq_tpu_torch import _kernels

    kname = name.split()[0]
    before = _kernels.LAUNCHES[kname]
    got = kernel()
    per_call = _kernels.LAUNCHES[kname] - before
    records = per_call * records_per_launch(kname)
    want = plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name} {shape}: kernel differs from plain (max_abs_err {err})")
    ms = time_ms(kernel, reps)
    if every_op:
        n_rec = card_records(kernel)
        if n_rec is None:
            dev_ms, dev_by = queued_ms(kernel, reps), "events"
        else:
            dev_ms, dev_by = device_ms(kernel, kname, reps, n_rec, symbols=("",))
        extra = {**(extra or {}), "records_per_call": n_rec}
    else:
        dev_ms, dev_by = device_ms(kernel, kname, reps, records)
    rec = {
        "check": name,
        "shape": list(shape),
        "max_abs_err": err,
        "ms": ms,
        "device_ms": dev_ms,
        "device_ms_by": dev_by,
        "launches_per_call": per_call,
        "records_per_call": records,
        "plain_ms": time_ms(plain, max(3, reps // 4)),
        "launches": _kernels.LAUNCHES[kname] - before,
    }
    if library is not None:
        rec["library_ms"] = time_ms(library, max(3, reps // 4))
    rec.update(bound or {})
    rec.update(extra or {})
    emit(rec)
    return rec


def bound(bytes_moved: float, ops: float) -> dict:
    """Least time on the card: the larger of bytes over the memory rate and
    integer operations over the card's integer issue rate."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / INT_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
    }


def scores_bound(hit) -> dict:
    """tin, tout and the score (4 B each) and the hit byte per lane; the
    compares the function needs whatever the algorithm: per row of H hits,
    sorting its H tins and H touts (H log2 H each) and, per hit query, two
    searches of log2 H steps: 4 H log2 H."""
    b, w = hit.shape
    n = hit.sum(dim=1).double()
    ops = 4 * n * n.clamp(min=1).log2()
    return bound(13 * b * w, float(ops.sum()))


# kmer_front's integer operations per lane: the block-local index (4), two
# funnel-shift windows (2 shared loads, 2 shifts, an or and a mask each:
# 12), the ambiguity test (1), the 2-bit reversal (bit reversal, adjacent
# swap, shift: 7), the reverse complement (2), the minimum (1), murmur (add,
# three shift-xors, two multiplies: 9), the encoder (~10), three stores.
FRONT_OPS_PER_LANE = 49


def front_bound(b: int, lb: int, k: int, canon: bool = False) -> dict:
    """Codes and flags in (1 byte each per base); hash, enc, ambiguity out
    (8 + 4 + 1 bytes per lane, and 8 more with the canon plane);
    FRONT_OPS_PER_LANE operations per lane."""
    lanes = b * (lb - k + 1)
    return bound(2 * b * lb + (21 if canon else 13) * lanes, FRONT_OPS_PER_LANE * lanes)


def front_words_bound(b: int, lb: int, k: int, canon: bool = False) -> dict:
    """kmer_front on the packed feed: 3 bits per base in (2 code bits and
    a flag bit, as int32 words); as front_bound otherwise."""
    lanes = b * (lb - k + 1)
    return bound(b * lb * 3 // 8 + (21 if canon else 13) * lanes, FRONT_OPS_PER_LANE * lanes)


# pack_runs' integer operations per valid lane: two loads, two shuffles and
# the code compare (3), the ballot and prefix popcount (3), the run index
# and slot tests (3), the step's carry (2): ~13
RLE_OPS_PER_LANE = 13


def rle_bound(n_kmers, w: int, cols: int) -> dict:
    """An id (4 B) and a flag byte in per valid lane (p < n_kmers: the
    lanes past it are never read), n_kmers, call and hits (4 B each) in
    and a row of `cols` u32 words out per read; the operations of the
    valid lanes."""
    b = n_kmers.numel()
    valid = float(n_kmers.clamp(min=0, max=w).sum())
    return bound(5 * valid + 12 * b + 4 * b * cols, RLE_OPS_PER_LANE * valid)


def rle_hll_bound(n_kmers, w: int, cols: int, stop_given: bool) -> dict:
    """pack_runs with the fused HLL feed: rle_bound plus the feed's 2 B per
    lane of [B, W] out and, when hll_stop is its own tensor, its 4 B per
    read in (the feed's lanes past n_kmers need no input)."""
    b = n_kmers.numel()
    valid = float(n_kmers.clamp(min=0, max=w).sum())
    return bound(5 * valid + 12 * b + 4 * b * cols + 2 * b * w + (4 * b if stop_given else 0),
                 RLE_OPS_PER_LANE * valid)


def probe_bound(valid) -> dict:
    """Hash (8 B) and valid (1 B) in, value (4 B) out per query; per valid
    query one 4 B displacement word and one 16 B row; ~24 operations."""
    n, nv = valid.numel(), float(valid.sum())
    return bound(13 * n + 20 * nv, 24 * nv)


def probe_acc_bound(codes, k: int, nt: int, in_read, unset, probed, hits, planes, sectors=None) -> dict:
    """`chd_probe_acc`, the routed pass: the acc word (4 B) in per lane in
    its read (`in_read`: the lanes still 0 are found by reading it); the
    packed code and flag words (3 bits a base) and the length of each row
    with a lane still 0 in its read (`unset`), and the bin work of its bases
    (13 operations an nt-mer position and 6 a lane, as bins_bound); per
    probed lane (`probed`: still 0, free of ambiguous bases, its bin in the
    chunk's range) of each table plane a 32 B sector, but no more than the
    plane (each input read once), and ~33 operations (the hash 9, the probe
    24); the acc word out where it hit (`hits`). `sectors`: the random
    sectors each plane needs, where they are not one a probed lane (a raw
    table's `rows_probe_acc`: two tag rows a probed lane, a confirm row a
    screened one)."""
    lb = 16 * codes.shape[1]
    rows = int(unset.any(dim=1).sum())
    n_probed = float(probed.sum())
    sectors = sectors or [n_probed] * len(planes)
    table = sum(min(p.numel() * p.element_size(), 32 * n) for p, n in zip(planes, sectors))
    moved = 4 * float(in_read.sum()) + rows * (lb * 3 // 8 + 4) + table + 4 * float(hits.sum())
    ops = rows * (13 * (lb - nt + 1) + 6 * (lb - k + 1)) + 33 * n_probed
    return bound(moved, ops)


def rows_split(planes, h, valid) -> dict:
    """Where the raw probe's valid queries screen, by the kernel's rounds
    (probe_rows_rounds of the package under test; on a package without it,
    the same tag compares here): "b1" (a slot of the first bucket), "b2" (no
    slot of the first, one of the second, the buckets differ), "none"; and
    "b2_reads", the valid queries that read the second bucket's tag row (no
    slot of the first screened and the buckets differ)."""
    import torch

    from krakenuniq_tpu_torch.db.hash_table import GOLDEN
    from krakenuniq_tpu_torch.ints import i32_to_u32, lsr, s64
    from krakenuniq_tpu_torch.lookup import hash_lookup

    ptags = planes[0]
    lb = ptags.shape[0].bit_length() - 1
    hf, vf = h.reshape(-1), valid.reshape(-1)
    hg = hf * s64(int(GOLDEN))
    b1, b2 = lsr(hf, 64 - lb), lsr(hg, 64 - lb)
    rounds = getattr(hash_lookup, "probe_rows_rounds", None)
    if rounds is not None:
        where = rounds(*planes, hf, lb)[1]
    else:
        s1 = (i32_to_u32(ptags[b1]) == lsr(hf << lb, 32)[:, None]).any(dim=1)
        s2 = (i32_to_u32(ptags[b2]) == lsr(hg << lb, 32)[:, None]).any(dim=1) & ~s1 & (b1 != b2)
        where = torch.where(s1, 1, torch.where(s2, 2, 0))
    w = where[vf]
    return {"b1": int((w == 1).sum()), "b2": int((w == 2).sum()), "none": int((w == 0).sum()),
            "b2_reads": int((vf & (where != 1) & (b1 != b2)).sum())}


def rows_sectors(split: dict) -> list:
    """The random sectors the raw probe needs of each plane, as
    probe_acc_bound takes them: a tag row a valid query and the second
    bucket's where the first does not screen; a confirm row a screened one."""
    return [split["b1"] + split["b2"] + split["none"] + split["b2_reads"], split["b1"] + split["b2"]]


def rows_bound(valid, split: dict, planes) -> dict:
    """`rows_probe`: hash (8 B) and valid (1 B) in, value (4 B) out per
    query; a random 32 B sector of each tag row and confirm row the valid
    queries need (`split`: rows_split; rows_sectors), no more than each
    plane; ~30 operations (two buckets and tags, four tag compares, the slot
    index, the confirm compare)."""
    n, nv = valid.numel(), float(valid.sum())
    tags, conf = rows_sectors(split)
    return bound(13 * n + sum(min(32 * k, p.numel() * 4) for k, p in zip((tags, conf), planes)), 30 * nv)


def fused_rows(fused, h, valid, lb: int) -> dict:
    """Where the fused probe's answers come from, by the kernel's algorithm
    (probe_fused_rounds of the package under test; None on a package
    without it): the valid queries answered by their first row, by their
    second (row 1 held no value for them), and missed."""
    from krakenuniq_tpu_torch.lookup import hash_lookup

    rounds = getattr(hash_lookup, "probe_fused_rounds", None)
    if rounds is None:
        return {"row1": None, "row2": None, "missed": None}
    _, answered = rounds(fused, h.reshape(-1), lb)
    a = answered[valid.reshape(-1)]
    return {"row1": int((a == 1).sum()), "row2": int((a == 2).sum()), "missed": int((a == 0).sum())}


def fused_bound(valid, rows: dict, table_bytes: int) -> dict:
    """`fused_probe`: hash (8 B) and valid (1 B) in, value (4 B) out per
    query; per valid query its first-choice row (16 B), and its second where
    the first holds no value for it (`rows`: fused_rows; with no rows known,
    both rows of every valid query), the rows no more than the plane; ~30
    operations (two bucket indices, two tags and high words, four slot
    compares, the select)."""
    n, nv = valid.numel(), float(valid.sum())
    read = 2 * nv if rows["row1"] is None else nv + rows["row2"] + rows["missed"]
    return bound(13 * n + min(16 * read, table_bytes), 30 * nv)


def bins_bound(b: int, lb: int, k: int, nt: int, packed: bool) -> dict:
    """`kmer_bins`: the codes in (1 B a base, or 2 bits as packed words),
    the canonical k-mer and the bin out (8 + 8 B a lane); the function's own
    operations, whatever the kernel's loop: per base position one nt-mer
    rolled forward and reverse-complemented (code, two shifts and ors, the
    canonical minimum, the xor: 10) and its share of a sliding window
    minimum (van Herk/Gil-Werman: a prefix, a suffix and their minimum, 3);
    per lane the k-mer rolled the same way (6)."""
    lanes = b * (lb - k + 1)
    ntmers = b * (lb - nt + 1)
    return bound((b * lb // 4 if packed else b * lb) + 16 * lanes, 13 * ntmers + 6 * lanes)


def search_reads(planes, query, bins, valid, n_iter: int, bin_start: int) -> tuple[float, float]:
    """The sorted planes' bytes a search must read, each input once: every
    offsets entry a searched lane (valid, bin in range) needs (8 B each,
    adjacent bins sharing one), the key at every distinct result position of
    a searched lane with a non-empty bin (8 B) and the two values at every
    distinct hit position (8 B); and its operations, ~7 per search step, a
    lane's steps being what its bin needs (ceil(log2(size + 1))). Returns
    (bytes, operations)."""
    import torch

    from krakenuniq_tpu_torch.lookup.xla_lookup import search_bins

    keys, _, _, offsets = planes
    b = bins.reshape(-1) - bin_start
    n_bins = offsets.numel() - 1
    searched = valid.reshape(-1) & (b >= 0) & (b < n_bins)
    bs = b[searched]
    sizes = offsets[bs + 1] - offsets[bs]
    steps = float(torch.ceil(torch.log2(sizes.double() + 1)).sum())
    entries = int(torch.unique(torch.cat([bs, bs + 1])).numel())
    pos, found = search_bins(keys, offsets, query, bins, valid, n_iter, bin_start)
    probed = int(torch.unique(pos[searched][sizes > 0]).numel())
    hits = int(torch.unique(pos[found]).numel())
    return 8 * entries + 8 * probed + 8 * hits, 7 * steps


def bsearch_bound(planes, query, bins, valid, n_iter: int, bin_start: int) -> dict:
    """`bsearch_lookup`: per lane the query and bin (8 + 8 B) and the flag
    (1 B) in and two 4 B values out, the planes' reads of search_reads, and
    ~8 operations a lane besides the steps."""
    moved, ops = search_reads(planes, query, bins, valid, n_iter, bin_start)
    n = bins.numel()
    return bound(25 * n + moved, ops + 8 * n)


def words_bound(codes, ambig, lengths, k: int, nt: int, plane, n_iter: int, taxon0) -> dict:
    """`bsearch_words`, one database's pass: the packed code and flag words
    (3 bits a base) and the length of each row with a lane in its read, and
    the bin work of its bases as bins_bound counts it (13 operations an
    nt-mer position, 6 a lane); after the first database (taxon0 given) the
    taxon word of each lane in its read (4 B); the two 4 B values out per
    lane written (every lane of the first pass, the searched ones later);
    the planes' reads of search_reads for the searched lanes (in the read,
    free of ambiguous bases, still 0), and ~8 operations a lane."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_bins_plain, unpack_input
    from krakenuniq_tpu_torch.kmer import ops as kops

    keys, vals, vals_dense, offsets, bin_start = plane
    b, lbw = codes.shape
    lb = 16 * lbw
    w = lb - k + 1
    codes_u, ambig_u = unpack_input(codes, ambig)
    lane = torch.arange(w, device=codes.device)[None, :]
    in_read = lane < (lengths - (k - 1)).clamp(min=0)[:, None]
    searched = in_read & ~kops.window_any(ambig_u, k)
    if taxon0 is not None:
        searched &= taxon0 == 0
    canon, bins = kmer_bins_plain(codes_u, k, nt)
    moved, ops = search_reads((keys, vals, vals_dense, offsets), canon, bins, searched, n_iter, bin_start)
    rows = int(in_read.any(dim=1).sum())
    moved += rows * (lb * 3 // 8 + 4) + (4 * float(in_read.sum()) if taxon0 is not None else 0)
    moved += 8 * (b * w if taxon0 is None else float(searched.sum()))
    ops += rows * (13 * (lb - nt + 1) + 6 * w) + 8 * float(in_read.sum())
    return bound(moved, ops)


def counts_bound(segs, t: int) -> dict:
    """An id (4 B) and a mask byte in per lane of each (ids, mask) segment;
    each accumulator bin a segment's counted lanes touch (a distinct id in
    [0, t) under a set mask) read and written once (8 + 8 B); ~4 operations
    per lane."""
    import torch

    n = sum(ids.numel() for ids, _ in segs)
    touched = sum(int(torch.unique(ids[m & (ids >= 0) & (ids < t)]).numel()) for ids, m in segs)
    return bound(5 * n + 16 * touched, 4 * n)


def regmax_bound(lanes, slots) -> dict:
    """A taxon, an encoding (4 B each) and a lane byte in per lane; each
    register the counted lanes touch (`slots`, flat indices) read and
    written once; ~16 operations per counted lane (rank decode, slot,
    compare)."""
    touched = int(slots.unique().numel())
    return bound(9 * lanes.numel() + 2 * touched, 16 * float(lanes.sum()))


# sparse_stats' integer operations per sorted lane after the sort: the key
# and its group against both neighbours (4 compares of 64-bit values, 8),
# the flags (4), the segmented scan (count, max, group count: 4), the
# decision and emit tests (4): ~20
STATS_OPS_PER_LANE = 20
# sparse_keys' per lane: the row and column (2), three shifts, two ors, the
# pad select and the sign flip (7)
KEYS_OPS_PER_LANE = 9


def stats_bound(n: int, n_distinct: int, buf_len: int) -> dict:
    """The `sparse_stats` kernels' function after the sort: the sorted key
    (8 B) in per lane, the stream position (8 B) only at each pair's last
    lane (the `n_distinct` distinct keys that are not pads; the kernels
    read no other), the buffer (8 B a slot, pads included) and the two
    counts out; STATS_OPS_PER_LANE operations per lane. The key build and
    the sort before it are timed apart (the sparse_keys record, `sort_ms`)."""
    return bound(8 * n + 8 * n_distinct + 8 * buf_len + 8, STATS_OPS_PER_LANE * n)


def keys_bound(b: int, w: int, unit_bytes: int) -> dict:
    """`sparse_keys`: a taxon and an encoding (4 B each) and a lane flag (1
    B) in and the key (8 B) out per lane, a unit id in per row;
    KEYS_OPS_PER_LANE operations per lane."""
    return bound(17 * b * w + unit_bytes * b, KEYS_OPS_PER_LANE * b * w)


def dict_bound(n: int, b: int, cap: int, with_call: bool) -> dict:
    """`span_dict`: each id of the [B, W] plane and the [B] calls in (4 B),
    each local id out (4 B, the calls' too when remapped) and the lut (4 B
    a slot); ~4 operations per id (range test, flag, rank read, cap test)."""
    return bound(4 * (n + b) + 4 * (n + (b if with_call else 0)) + 4 * (cap + 1), 4 * (n + b))


def gather_bound(n: int, row_bytes: int) -> dict:
    """A 4 B index in, one row read and one row written per query."""
    return bound(n * (4 + 2 * row_bytes), 0)


def sort_boundary_ms(ids, mask, t: int, reps: int) -> float:
    """The JAX package's count form (an id sort plus t+1 boundary probes,
    classify/device_counters.py:79-87), timed on the same inputs."""
    import torch

    probes = torch.arange(t + 1, dtype=torch.int32, device=ids.device)

    def run():
        st = torch.sort(torch.where(mask, ids, t).reshape(-1)).values
        edges = torch.searchsorted(st, probes)
        return edges[1:] - edges[:-1]

    return time_ms(run, reps)


# ------------------------------------------------------------------ phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ phase 2


def score_inputs(b, w, seed, hit_rate=0.7, bad_rows=False):
    """Random intervals (tin < tout); with `bad_rows` each row's first hit
    gets tout < tin, which sends the row to the kernel's pair form."""
    import torch

    rng = np.random.default_rng(seed)
    tins = rng.integers(0, 5000, size=(b, w)).astype(np.int32)
    touts = (tins + rng.integers(1, 2500, size=(b, w))).astype(np.int32)
    hit = rng.random((b, w)) < hit_rate
    if bad_rows:
        rows = np.flatnonzero(hit.any(axis=1))
        first = hit[rows].argmax(axis=1)
        touts[rows, first] = tins[rows, first] - 1
    t = lambda a: torch.from_numpy(a).cuda()
    return t(tins), t(touts), t(hit)


def front_inputs(b, lb, seed, lengths=None):
    """Random bases, ~1% N, and per-row lengths (default: half the rows 150,
    the rest from 0 to lb, some below k); padding positions ambiguous with
    code 0, as encode_batch lays them out."""
    import torch

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, lb), dtype=np.uint8)
    ambig = rng.random((b, lb)) < 0.01
    if lengths is None:
        lengths = rng.integers(0, lb + 1, size=b)
        lengths[: b // 2] = 150
    else:
        lengths = np.resize(np.asarray(lengths), b)
    pad = np.arange(lb)[None, :] >= lengths[:, None]
    codes[pad] = 0
    ambig |= pad
    codes[ambig] = 0
    return torch.from_numpy(codes).cuda(), torch.from_numpy(ambig).cuda()


def phase_kernels(k: int):
    from krakenuniq_tpu_torch.classify.device_step import kmer_front, kmer_front_plain
    from krakenuniq_tpu_torch.taxonomy.resolve import _scores_plain, scores

    for i, (label, b, w, rate) in enumerate([
        ("", 4096, 130, 0.7), ("", 65536, 130, 0.7), ("", 64, 482, 0.7), ("", 5, 7, 0.7),
        (" all-miss", 64, 130, 0.0), (" all-hit", 4096, 130, 1.0),
        # long rows: 1025 lanes (one past four 256-lane hit tiles) and 2018
        (" W>1024", 16, 2018, 0.7), (" W>1024", 8, 1025, 0.7),
        # the span shape's loads and stores alone (no hit: no sort, no search)
        (" all-miss", 65536, 130, 0.0),
        # a tout < tin hit in every row: the whole batch takes the pair form
        (" tout<tin", 65536, 130, 0.7),
    ]):
        tins, touts, hit = score_inputs(b, w, i, hit_rate=rate, bad_rows=label == " tout<tin")
        check_kernel(
            "scores" + label, (b, w),
            lambda: (scores(tins, touts, hit),),
            lambda: (_scores_plain(tins, touts, hit),),
            reps=20, bound=scores_bound(hit),
        )
    for label, b, lb, kk, lengths in [
        ("", 65536, 160, k, None), ("", 4096, 160, k, None), (" k=21", 65536, 160, 21, None),
        (" LB=161", 4096, 161, k, None), (" short rows", 4096, 160, k, (0, k - 1, k, 150)),
    ]:
        codes, ambig = front_inputs(b, lb, 7, lengths)
        check_kernel(
            "kmer_front" + label, (b, lb),
            lambda: kmer_front(codes, ambig, kk, 12),
            lambda: kmer_front_plain(codes, ambig, kk, 12),
            reps=20, bound=front_bound(b, lb, kk), extra={"k": kk},
        )
    phase_span_kernels(k)
    phase_probe_kernel()
    phase_long_front_kernels(k)
    from krakenuniq_tpu_torch.classify import device_step

    fused_rec = phase_fallback_kernels() if hasattr(device_step, "kmer_bins") else None
    if hasattr(device_step, "bsearch_words"):
        phase_words_kernel()
    phase_acc_kernel()
    from krakenuniq_tpu_torch.lookup import hash_lookup

    rows_acc_rec = phase_rows_kernels() if hasattr(hash_lookup, "probe_rows_plain") else None
    phase_counter_kernels()

    if hasattr(device_step, "span_dict"):
        phase_dict_stats_kernels()
    else:
        log("this package has no span_dict or sparse_stats kernel")
    return phase_gather_kernel(), fused_rec, rows_acc_rec


def rle_inputs(b, w, seed, k=31):
    """One span's pack_runs inputs on the card: per read runs of pool ids
    (lengths 1-64, ids zipf-1.5 over 503), ~1% ambiguous lanes plus an
    ambiguous stretch in every eighth read (carrying varied ids, as the
    function allows), a quarter of the reads with a fresh id at every lane
    (far more runs than slots: overflow rows), n_kmers from reads of 0 to
    W + k - 1 bases (a tenth shorter than k: no k-mer); call and hits
    random."""
    import torch

    rng = np.random.default_rng(seed)
    run_len = rng.integers(1, 65, size=(b, w))
    starts = np.cumsum(run_len, axis=1) - run_len  # run j of read i starts here
    lane_run = np.stack([np.searchsorted(starts[i], np.arange(w), side="right") - 1 for i in range(min(b, 64))])
    lane_run = np.resize(lane_run, (b, w))
    run_ids = (rng.zipf(1.5, size=(b, w)) % 503).astype(np.int32)
    ids = np.take_along_axis(run_ids, lane_run, axis=1)
    noisy = rng.random(b) < 0.25
    ids[noisy] = rng.integers(0, 503, size=(int(noisy.sum()), w))
    amb = rng.random((b, w)) < 0.01
    amb[::8, 20:50] = True
    ids[amb] = rng.integers(0, 503, size=int(amb.sum()))
    lengths = rng.integers(0, w + k, size=b)
    lengths[: b // 2] = w + k - 1
    lengths[::10] = rng.integers(0, k, size=len(lengths[::10]))
    nk = np.maximum(lengths - (k - 1), 0).astype(np.int32)
    call = rng.integers(0, 503, size=b).astype(np.int32)
    hits = rng.integers(0, w + 1, size=b).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return t(ids), t(amb), t(nk), t(call), t(hits)


def quick_stop(nk, w: int, seed: int):
    """hll_stop for pack_runs inputs: each read's valid lanes, min(n_kmers,
    W), and for every third read a quick-mode cut below them."""
    import torch

    rng = np.random.default_rng(seed)
    stop = np.clip(nk.cpu().numpy(), 0, w)
    cut = np.arange(len(stop)) % 3 == 1
    stop[cut] = rng.integers(0, stop[cut] + 1)
    return torch.from_numpy(stop.astype(np.int32)).to(nk.device)


def feed_check(ds, label, ids, amb, nk, call, hits, stop, r, reps):
    """`pack_runs compact+hll`: the compact rows and the span step's u16 HLL
    feed (lanes below `stop`, None for n_kmers, and not ambiguous) from one
    pack_runs call; in a package whose pack_runs lacks the feed, the kernel
    plus the torch ops its step built the feed with ("form" says which).
    device_ms counts every card record of a call in both forms."""
    import inspect

    import torch

    w = ids.shape[1]

    def ops():
        lane = torch.arange(w, device=ids.device)
        counted = (lane[None, :] < (nk if stop is None else stop)[:, None]) & ~amb
        return torch.where(counted, ids & 0xFFFF, 0xFFFF).to(torch.int16)

    if "hll16" in inspect.signature(ds.pack_runs).parameters:
        form = "fused"
        run = lambda: ds.pack_runs(ids, amb, nk, call, hits, r, "compact", hll16=True, hll_stop=stop)
        plain = lambda: ds.pack_runs_plain(ids, amb, nk, call, hits, r, "compact", hll16=True, hll_stop=stop)
    else:
        form = "kernel + torch ops"
        run = lambda: (ds.pack_runs(ids, amb, nk, call, hits, r, "compact"), ops())
        plain = lambda: (ds.pack_runs_plain(ids, amb, nk, call, hits, r, "compact"), ops())
    return check_kernel(
        "pack_runs compact+hll" + label, tuple(ids.shape), run, plain, reps=reps,
        bound=rle_hll_bound(nk, w, ds.pack_runs_cols("compact", r), stop is not None),
        extra={"max_runs": r, "form": form}, every_op=True,
    )


def phase_span_kernels(k: int, r: int = 8):
    """The span route's two kernels at the unit and span shapes: the
    packed-input kmer_front (the words of pack_input, which lays rows out as
    encode_unit_packed does) and pack_runs in its three row layouts (the
    wide one through a 2.4M-id map) and with the fused HLL feed (quick-mode
    cuts on a third of the reads), then on a ragged [65535, 130] (a last
    tile of 15 reads), on row-sliced planes whose base is off the 16-byte
    grid (ids[1:] at W = 130 starts 8 bytes off), and at W = 482, 33 and
    4000. Skipped, with a note, on a package that has neither kernel."""
    import torch

    from krakenuniq_tpu_torch.classify import device_step as ds

    if not hasattr(ds, "pack_runs"):
        log("this package has no span kernels (pack_runs, kmer_front_words)")
        return
    for b, lb in ((4096, 160), (65536, 160)):
        codes, ambig = front_inputs(b, lb, 7)
        cw, aw = ds.pack_input(codes, ambig)
        check_kernel(
            "kmer_front packed", (b, lb),
            lambda: ds.kmer_front_words(cw, aw, k, 12),
            lambda: ds.kmer_front_packed(cw, aw, lb, k, 12),
            reps=20, bound=front_words_bound(b, lb, k), extra={"k": k},
        )
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randint(0, 1 << 31, (PAD_NODES + 503,), dtype=torch.int32, device="cuda", generator=gen)
    for b, w in ((4096, 130), (65536, 130)):
        ids, amb, nk, call, hits = rle_inputs(b, w, b)
        for layout in ("compact", "dense", "wide"):
            mt = table if layout == "wide" else None
            check_kernel(
                f"pack_runs {layout}", (b, w),
                lambda: (ds.pack_runs(ids, amb, nk, call, hits, r, layout, mt),),
                lambda: (ds.pack_runs_plain(ids, amb, nk, call, hits, r, layout, mt),),
                reps=20, bound=rle_bound(nk, w, ds.pack_runs_cols(layout, r)),
                extra={"max_runs": r},
            )
        feed_check(ds, "", ids, amb, nk, call, hits, quick_stop(nk, w, b), r, 20)
        n_runs = ds.pack_runs(ids, amb, nk, call, hits, r, "compact")[:, r] & 0xFFFF
        if not bool((n_runs > r).any()) or not bool((nk == 0).any()):
            raise AssertionError("pack_runs inputs hold no overflow row or no read shorter than k")
    planes = rle_inputs(65537, 130, 65537)
    for label, (ids, amb, nk, call, hits) in ((" ragged", [x[:65535] for x in planes]),
                                               (" misaligned", [x[1:] for x in planes])):
        b, w = ids.shape
        check_kernel(
            f"pack_runs compact{label}", (b, w),
            lambda: (ds.pack_runs(ids, amb, nk, call, hits, r, "compact"),),
            lambda: (ds.pack_runs_plain(ids, amb, nk, call, hits, r, "compact"),),
            reps=10, bound=rle_bound(nk, w, ds.pack_runs_cols("compact", r)),
            extra={"max_runs": r, "ids_offset_bytes": ids.data_ptr() % 16},
        )
        feed_check(ds, label, ids, amb, nk, call, hits, quick_stop(nk, w, b), r, 10)
    # rows past one step of the kernel's walk (W = 482: several steps, the
    # previous step's last code carried past its feed words), an odd W with
    # a ragged last tile, and a W too long for two stages (plain loads)
    for b, w in ((4096, 482), (65, 33), (256, 4000)):
        ids, amb, nk, call, hits = rle_inputs(b, w, w)
        check_kernel(
            "pack_runs compact", (b, w),
            lambda: (ds.pack_runs(ids, amb, nk, call, hits, r, "compact"),),
            lambda: (ds.pack_runs_plain(ids, amb, nk, call, hits, r, "compact"),),
            reps=5, bound=rle_bound(nk, w, ds.pack_runs_cols("compact", r)), extra={"max_runs": r},
        )
        feed_check(ds, "", ids, amb, nk, call, hits, quick_stop(nk, w, b), r, 5)


def probe_floor(rows, n_valid: int, seed: int) -> dict:
    """floor_ms: the row_gather kernel's device_ms for n_valid random 16 B
    rows of the same row plane (S = 16 copies in flight, 16 loads per lane,
    so even a unit's queries fill the card): the one-level random-sector
    rate that the two-level probe is judged against."""
    import torch

    from krakenuniq_tpu_torch.tools.probe_gather import row_gather

    gen = torch.Generator(device=rows.device).manual_seed(seed)
    q = torch.randint(0, rows.shape[0], (n_valid,), dtype=torch.int32, device=rows.device, generator=gen)
    floor, by = device_ms(lambda: row_gather(rows, q, 16, 16), "row_gather", 10)
    return {"floor_ms": floor, "floor_ms_by": by}


def plant_hits(planes, h, seed: int):
    """Store each query of `h` in slot 0 of its CHD row with a random value
    in [1, 2^min(lr, 20)), so the probe's match path runs on random planes;
    returns the values (a later query wins a row that two share)."""
    import torch

    from krakenuniq_tpu_torch.db.hash_table import C2, GOLDEN
    from krakenuniq_tpu_torch.ints import i32_to_u32, lsr, s64, u32_to_i32
    from krakenuniq_tpu_torch.lookup.hash_lookup import _chd_widths

    disp4, rows = planes
    lr, lg = _chd_widths(disp4, rows)
    r = h & ((1 << (64 - lr)) - 1)
    d = i32_to_u32(disp4.reshape(-1)[lsr(r * s64(int(GOLDEN)), 64 - lg)])
    row = (lsr(h, 64 - lr) + (d & 0xFFFF) + (d >> 16) * lsr(r * s64(int(C2)), 64 - lr)) & ((1 << lr) - 1)
    gen = torch.Generator(device=h.device).manual_seed(seed)
    vals = torch.randint(1, 1 << min(lr, 20), h.shape, dtype=torch.int64, device=h.device, generator=gen)
    rows[row, 0] = u32_to_i32(r >> (32 - lr))
    rows[row, 1] = u32_to_i32(((r & ((1 << (32 - lr)) - 1)) << lr) | vals)
    return vals


def random_hashes(n: int, gen):
    """n uniformly random int64 hashes (uint64 bit patterns) on gen's device."""
    import torch

    hi, lo = (torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=gen.device, generator=gen)
              for _ in range(2))
    return (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)


def phase_probe_kernel():
    """chd_probe on a random 16 MB table at the unit shape (it fits the L2),
    and on random planes of the phase-4 table's size (lr = 26, lg = 24,
    1.14 GB, built on the card): 8,500,000 uniform hashes with ~1% invalid
    lanes, half of them planted in the table, and the unit shape [4096, 130]
    drawn zipf-1.5 from 10M distinct hashes, half of them planted (the reuse
    of real reads). Each record carries floor_ms (probe_floor)."""
    import torch

    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(a).cuda()
    word = lambda n: rng.integers(-(1 << 31), 1 << 31, size=(n, 4), dtype=np.int64).astype(np.int32)
    planes = (t(word(1 << 16)), t(word(1 << 20)))  # displacement words, 2^20 rows of 16 B
    h = t(rng.integers(0, 1 << 64, size=(4096, 130), dtype=np.uint64).view(np.int64))
    valid = t(rng.random((4096, 130)) < 0.9)
    probe_case("chd_probe 16 MB table", planes, h, valid, 20)

    gen = torch.Generator(device="cuda").manual_seed(17)
    rand_i32 = lambda *shape: torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda",
                                            generator=gen)
    planes = (rand_i32(1 << 22, 4), rand_i32(1 << 26, 4))
    n = 8_500_000
    h = random_hashes(n, gen)
    valid = torch.rand(n, device="cuda", generator=gen) >= 0.01
    vals = plant_hits(planes, h[: n // 2], 19)
    got = probe_case("chd_probe 1 GiB table", planes, h, valid, 10)[: n // 2]
    ok = valid[: n // 2]
    if float((got[ok] == vals[ok]).float().mean()) < 0.9:
        raise AssertionError("chd_probe 1 GiB table: planted keys did not return their values")
    pool = torch.unique(random_hashes(10_000_000, gen))
    plant_hits(planes, pool[: pool.numel() // 2], 23)
    pick = torch.from_numpy(rng.zipf(1.5, size=4096 * 130) % pool.numel()).cuda()
    hz = pool[pick].reshape(4096, 130)
    vz = torch.rand((4096, 130), device="cuda", generator=gen) < 0.9
    probe_case("chd_probe 1 GiB table zipf", planes, hz, vz, 20)
    del planes, h, valid, vals, got, pool, hz
    torch.cuda.empty_cache()


def phase_long_front_kernels(k: int):
    """kmer_front's canon plane, both entries against their plain versions
    with canon at the span shape [65536, 160] (the exact span step) and with
    and without it at the long-read step's rows [8, LONG_READ_LB] (one block
    a row); then chd_probe on those rows' hashes over random planes of the
    phase-4 table's size (lr = 26), half the searched lanes planted.
    Skipped, with a note, on a package whose kmer_front has no canon."""
    import inspect

    import torch

    from krakenuniq_tpu_torch.classify import device_step as ds

    if "canon" not in inspect.signature(ds.kmer_front).parameters:
        log("this package's kmer_front has no canon output")
        return
    for b, lb, lengths in ((65536, 160, None), (8, LONG_READ_LB, LONG_READ_LENGTHS)):
        codes, ambig = front_inputs(b, lb, 7, lengths)
        cw, aw = ds.pack_input(codes, ambig)
        for canon in ((False, True) if lb == LONG_READ_LB else (True,)):
            label = " canon" if canon else ""
            check_kernel(
                "kmer_front" + label, (b, lb),
                lambda: ds.kmer_front(codes, ambig, k, 12, canon=canon),
                lambda: ds.kmer_front_plain(codes, ambig, k, 12, canon=canon),
                reps=20, bound=front_bound(b, lb, k, canon), extra={"k": k, "canon": canon},
            )
            check_kernel(
                "kmer_front packed" + label, (b, lb),
                lambda: ds.kmer_front_words(cw, aw, k, 12, canon=canon),
                lambda: ds.kmer_front_packed(cw, aw, lb, k, 12, canon=canon),
                reps=20, bound=front_words_bound(b, lb, k, canon), extra={"k": k, "canon": canon},
            )
    gen = torch.Generator(device="cuda").manual_seed(37)
    rand_i32 = lambda *shape: torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda",
                                            generator=gen)
    planes = (rand_i32(1 << 22, 4), rand_i32(1 << 26, 4))
    b, lb = len(LONG_READ_LENGTHS), LONG_READ_LB
    h, _, amb = ds.kmer_front(*front_inputs(b, lb, 9, LONG_READ_LENGTHS), k, 12)
    lens = torch.tensor(LONG_READ_LENGTHS, device="cuda")
    valid = (torch.arange(lb - k + 1, device="cuda")[None, :] < (lens - (k - 1)).clamp(min=0)[:, None]) & ~amb
    plant_hits(planes, h[valid & (torch.rand(valid.shape, device="cuda", generator=gen) < 0.5)], 41)
    got = probe_case("chd_probe long-read rows 1 GiB table", planes, h, valid, 20)
    if not bool((got != 0).any()):
        raise AssertionError("chd_probe long-read rows: no planted lane found")
    del planes, h, valid, got
    torch.cuda.empty_cache()


def phase_acc_kernel():
    """chd_probe_acc against its plain version (probe_chunk_core) on random
    CHD planes: lr = 20 (16 MB of rows, within the L2) and lr = 24 (268 MB,
    the rows streamed), at the span shape [4096, 160] with k = 31 and nt =
    12 and 20, and at long rows (LONG_KNT at [64, LONG_LB], lr = 20). In each
    case ~1% of the bases ambiguous, half the searched lanes' k-mers planted
    in the table, a seeded 30% of the words already set, and the bin range
    the middle half of the searched lanes' bins, so that planted lanes lie
    inside it and on both sides; the kernel must set some lanes, and no
    planted lane outside the range."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words, pack_input

    gen = torch.Generator(device="cuda").manual_seed(61)
    rand_i32 = lambda *shape: torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda",
                                            generator=gen)
    cases = [(20, 4096, 160, 31, 12), (20, 4096, 160, 31, 20), (24, 4096, 160, 31, 12)]
    cases += [(20, 64, LONG_LB, k, nt) for k, nt in LONG_KNT]
    cases += [(24, 8, LONG_READ_LB, 31, 12)]  # the long-read step's rows out of core
    for i, (lr, b, lb, k, nt) in enumerate(cases):
        planes = (rand_i32(1 << (lr - 4), 4), rand_i32(1 << lr, 4))
        lengths = {160: (150, 160, 0, k - 1, k, 100), LONG_LB: LONG_LENGTHS}.get(lb, LONG_READ_LENGTHS)
        codes, ambig = front_inputs(b, lb, 70 + i, lengths)
        feed = (*pack_input(codes, ambig), torch.from_numpy(np.resize(np.asarray(lengths, np.int32), b)).cuda())
        in_read, searched, bins = span_lanes(feed, k, nt)
        hashes = kmer_front_words(feed[0], feed[1], k, 12)[0]
        planted = searched & (torch.rand(searched.shape, device="cuda", generator=gen) < 0.5)
        plant_hits(planes, hashes[planted], 71 + i)
        sb = bins[searched].sort().values
        lo, hi = int(sb[sb.numel() // 4]), int(sb[3 * sb.numel() // 4])
        inside = (bins >= lo) & (bins < hi)
        acc0 = torch.where(torch.rand(bins.shape, device="cuda", generator=gen) < 0.3,
                           rand_i32(*bins.shape) | 1, 0)
        run = acc_pass(feed, planes, (lo, hi), k, nt)
        acc_k, acc_p = torch.empty_like(acc0), torch.empty_like(acc0)
        got = run(acc_p.copy_(acc0), plain=True)
        hits = got != acc0
        away = planted & (acc0 == 0) & ~inside
        if not hits.any() or not away.any() or got[away].any():
            raise AssertionError(f"chd_probe_acc random lr={lr} k={k} nt={nt}: {int(hits.sum())} lanes set, "
                                 f"{int(away.sum())} planted outside [{lo}, {hi}), of them "
                                 f"{int((got[away] != 0).sum())} set")
        probed = searched & (acc0 == 0) & inside
        check_kernel(
            f"chd_probe_acc random lr={lr} k={k} nt={nt}", (b, lb - k + 1),
            lambda: (run(acc_k.copy_(acc0)),),
            lambda: (run(acc_p.copy_(acc0), plain=True),),
            reps=10, bound=probe_acc_bound(feed[0], k, nt, in_read, in_read & (acc0 == 0), probed, hits, planes),
            extra={"k": k, "nt": nt, "lr": lr, "bins": [lo, hi], "lanes_probed": int(probed.sum()),
                   "lanes_set": int(hits.sum()), "lanes_planted_outside": int(away.sum())},
        )
        del planes
    torch.cuda.empty_cache()


# Phase 13's UID table: 110,988,000 keys at load 0.6 take lb = 27 (ptags
# 1.07 GB, confirm 2.15 GB); phase 8's budget (512 MiB, planned at half for
# two slots) gives raw chunk tables of lb = 23 (201 MB)
UID_LB, UID_CHUNK_LB = 27, 23


def plant_raw(planes, h, seed: int, split=None):
    """Store the first half of `h` (the first `split` keys) in slot 0 of its
    first-choice bucket and the rest in slot 1 of its second-choice bucket, as the two-level
    build lays keys out (the bucket's tag, the slot's confirm row: the low
    32 hash bits and a random nonzero 32-bit value); returns the values as
    int32 bit patterns (a later query wins a slot that two share)."""
    import torch

    from krakenuniq_tpu_torch.db.hash_table import GOLDEN
    from krakenuniq_tpu_torch.ints import lsr, s64, u32_to_i32

    ptags, confirm = planes
    lb = ptags.shape[0].bit_length() - 1
    gen = torch.Generator(device=h.device).manual_seed(seed)
    vals = u32_to_i32(torch.randint(1, 1 << 32, h.shape, dtype=torch.int64, device=h.device, generator=gen))
    half = h.numel() // 2 if split is None else split
    for part, choice in ((slice(0, half), 0), (slice(half, None), 1)):
        hp = h[part]
        hc = hp * s64(int(GOLDEN)) if choice else hp
        bucket = lsr(hc, 64 - lb)
        ptags[bucket, choice] = u32_to_i32(lsr(hc << lb, 32))
        confirm[2 * bucket + choice, 0] = u32_to_i32(hp & 0xFFFFFFFF)
        confirm[2 * bucket + choice, 1] = vals[part]
    return vals


def raw_planes(lb: int, gen):
    """Random two-level planes of width 2^lb on the card: ptags int32
    [2^lb, 2], confirm int32 [2^(lb+1), 2]."""
    import torch

    return tuple(torch.randint(-(1 << 31), 1 << 31, (n << lb, 2), dtype=torch.int32, device="cuda", generator=gen)
                 for n in (1, 2))


def rows_case(name, planes, h, valid, reps, seed):
    """rows_probe against its plain version (check_kernel) with its bound
    (rows_bound), the split of its valid queries (rows_split), floor_ms
    (row_gather over the confirm plane's 16-byte rows, one random row a
    valid query) and floor_mix_ms (as many random rows as the sectors the
    function needs, rows_sectors); returns the kernel's output and the
    record."""
    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain

    hf, vf = h.reshape(-1), valid.reshape(-1)
    split = rows_split(planes, hf, vf)
    nv = int(vf.sum())
    mix = probe_floor(planes[1].view(-1, 4), sum(rows_sectors(split)), seed + 1)
    rec = check_kernel(
        name, tuple(h.shape),
        lambda: (hash_lookup_kmers(planes, h, valid),),
        lambda: (hash_lookup_plain(planes, h, valid),),
        reps=reps, bound=rows_bound(vf, split, planes),
        extra={"lb": planes[0].shape[0].bit_length() - 1, "table_gb": sum(p.numel() * 4 for p in planes) / 1e9,
               "queries_valid": nv, "split": split, "b1_share": split["b1"] / nv if nv else None,
               "queries_screened": split["b1"] + split["b2"],
               **probe_floor(planes[1].view(-1, 4), nv, seed),
               "floor_mix_ms": mix["floor_ms"], "floor_mix_ms_by": mix["floor_ms_by"]},
    )
    return hash_lookup_kmers(planes, hf, vf), rec


def raw_edge_case(gen, lb: int = 18):
    """rows_probe's edge cases on random planes of width 2^lb (small, so
    that coinciding buckets are common), each planted and probed by the
    kernel and its plain version: keys whose two buckets coincide (half
    stored in slot 0 of it under their first-choice tag, half in slot 1
    under their second-choice tag, which the probe never compares there, so
    those miss), keys stored in their second bucket behind a first
    bucket that screens them falsely (a tag equal to theirs, a confirm row
    that is not), and zero-tag keys stored in slot 1 behind an empty slot 0
    (tag 0, confirm (0, 0)). The probe confirms only the first screened
    slot, so these two kinds miss too; the kernel must agree with the plain
    version on all of them."""
    import torch

    from krakenuniq_tpu_torch.db.hash_table import GOLDEN
    from krakenuniq_tpu_torch.ints import lsr, s64, u32_to_i32

    planes = raw_planes(lb, gen)
    ptags, confirm = planes
    h = random_hashes(1 << 26, gen)
    coincide = h[lsr(h, 64 - lb) == lsr(h * s64(int(GOLDEN)), 64 - lb)]
    same, same2 = coincide[0::2], coincide[1::2]
    vals_same = plant_raw(planes, same, 83, split=same.numel())  # first-choice tags, as the build stores them
    plant_raw(planes, same2, 84, split=0)  # second-choice tags in slot 1: never compared in one bucket
    false_screen = random_hashes(1024, gen)
    b1 = lsr(false_screen, 64 - lb)
    hg = false_screen * s64(int(GOLDEN))
    b2 = lsr(hg, 64 - lb)
    ptags[b1, 0] = u32_to_i32(lsr(false_screen << lb, 32))
    confirm[2 * b1, 0] = u32_to_i32((false_screen & 0xFFFFFFFF) ^ 1)
    ptags[b2, 0] = u32_to_i32(lsr(hg << lb, 32))
    confirm[2 * b2, 0] = u32_to_i32(false_screen & 0xFFFFFFFF)
    confirm[2 * b2, 1] = 7
    zero_tag = (torch.randint(0, 1 << lb, (1024,), device="cuda", generator=gen) << (64 - lb)) | torch.randint(
        1, 1 << (32 - lb), (1024,), device="cuda", generator=gen)
    zb = lsr(zero_tag, 64 - lb)
    ptags[zb] = 0
    confirm[2 * zb] = 0
    confirm[2 * zb + 1, 0] = u32_to_i32(zero_tag & 0xFFFFFFFF)
    confirm[2 * zb + 1, 1] = 9
    h = torch.cat([same, same2, false_screen, zero_tag, random_hashes(4096, gen)])
    valid = torch.ones(h.shape, dtype=torch.bool, device="cuda")
    got = rows_case(f"rows_probe edge cases lb={lb}", planes, h, valid, 10, 87)[0]
    n1, n2 = same.numel(), same.numel() + same2.numel() + false_screen.numel() + zero_tag.numel()
    found_same = float((got[:n1] == vals_same).float().mean()) if n1 else 1.0
    missed = float((got[n1:n2] == 0).float().mean())
    if n1 < 16 or found_same < 0.9 or missed < 0.9:
        raise AssertionError(f"rows_probe edge cases: {n1} coinciding-bucket keys ({found_same:.3f} found), "
                             f"{missed:.3f} of the misses the probe's rules make missed")
    return {"coinciding_bucket_keys": n1, "coinciding_second_tag_keys": same2.numel(),
            "false_screen_keys": false_screen.numel(), "zero_tag_keys": zero_tag.numel()}


def phase_rows_kernels(n: int = 8_500_000):
    """The raw two-level (UID) table's kernels against their plain versions:
    rows_probe's edge cases (raw_edge_case); rows_probe on random planes of
    phase 13's table size (lb = UID_LB: 3.2 GB) with n uniform queries, ~1%
    invalid, half of them planted, and on the long-read step's rows [8,
    LONG_READ_LB] over the same planes, half the searched lanes planted; and
    rows_probe_acc (probe_chunk_core on a raw chunk table) on a random raw
    chunk of phase 8's chunk width (lb = UID_CHUNK_LB) at [4096, 160] and
    at the span shape [65536, 160] (raw_acc_case). Returns rows_probe_acc's
    record at [4096, 160]."""
    import torch

    from krakenuniq_tpu_torch.classify import device_step as ds

    gen = torch.Generator(device="cuda").manual_seed(79)
    edges = raw_edge_case(gen)
    log(f"rows_probe edge cases: kernel == plain {edges}")
    planes = raw_planes(UID_LB, gen)
    h = random_hashes(n, gen)
    valid = torch.rand(n, device="cuda", generator=gen) >= 0.01
    vals = plant_raw(planes, h[: n // 2], 89)
    got = rows_case(f"rows_probe lb={UID_LB}", planes, h, valid, 10, 91)[0]
    ok = valid[: n // 2]
    if float((got[: n // 2][ok] == vals[ok]).float().mean()) < 0.9:
        raise AssertionError(f"rows_probe lb={UID_LB}: planted keys did not return their values")

    b, lb, k = len(LONG_READ_LENGTHS), LONG_READ_LB, 31
    hl, _, amb = ds.kmer_front(*front_inputs(b, lb, 9, LONG_READ_LENGTHS), k, 12)
    lens = torch.tensor(LONG_READ_LENGTHS, device="cuda")
    lvalid = (torch.arange(lb - k + 1, device="cuda")[None, :] < (lens - (k - 1)).clamp(min=0)[:, None]) & ~amb
    plant_raw(planes, hl[lvalid & (torch.rand(lvalid.shape, device="cuda", generator=gen) < 0.5)], 93)
    if not bool((rows_case("rows_probe long-read rows", planes, hl, lvalid, 20, 95)[0] != 0).any()):
        raise AssertionError("rows_probe long-read rows: no planted lane found")
    del planes, h, valid, vals, got, hl, lvalid
    torch.cuda.empty_cache()

    planes = raw_planes(UID_CHUNK_LB, gen)
    recs = [raw_acc_case(planes, gen, b, seed) for b, seed in ((4096, 97), (65536, 98))]
    del planes
    torch.cuda.empty_cache()
    return recs[0]


def raw_acc_case(planes, gen, b: int, seed: int, k: int = 31, nt: int = 12) -> dict:
    """rows_probe_acc (probe_chunk_core) against its plain version on the
    random raw chunk `planes` at [b, 160] (k = 31, nt = 12): half the words
    already set, half the searched lanes planted, the bin range the middle
    half of the searched lanes' bins; with its bound (the split of the
    probed lanes, rows_split) and floor_ms over the probed lanes. Returns
    the record ("rows_probe_acc lb=23", with " span" at b = 65536)."""
    import torch

    from krakenuniq_tpu_torch.classify import device_step as ds

    lb = 160
    lengths = (150, 160, 0, k - 1, k, 100)
    codes, ambig = front_inputs(b, lb, seed, lengths)
    feed = (*ds.pack_input(codes, ambig), torch.from_numpy(np.resize(np.asarray(lengths, np.int32), b)).cuda())
    in_read, searched, bins = span_lanes(feed, k, nt)
    hashes = ds.kmer_front_words(feed[0], feed[1], k, 12)[0]
    plant_raw(planes, hashes[searched & (torch.rand(searched.shape, device="cuda", generator=gen) < 0.5)], seed + 2)
    sb = bins[searched].sort().values
    lo, hi = int(sb[sb.numel() // 4]), int(sb[3 * sb.numel() // 4])
    acc0 = torch.where(torch.rand(bins.shape, device="cuda", generator=gen) < 0.5,
                       torch.randint(1, 1 << 31, bins.shape, dtype=torch.int32, device="cuda", generator=gen), 0)
    run = acc_pass(feed, planes, (lo, hi), k, nt)
    acc_k, acc_p = torch.empty_like(acc0), torch.empty_like(acc0)
    hits = run(acc_p.copy_(acc0), plain=True) != acc0
    probed = searched & (acc0 == 0) & (bins >= lo) & (bins < hi)
    split = rows_split(planes, hashes[probed], torch.ones(int(probed.sum()), dtype=torch.bool, device="cuda"))
    if not hits.any():
        raise AssertionError("rows_probe_acc: the pass set no lane")
    return check_kernel(
        f"rows_probe_acc lb={UID_CHUNK_LB}{' span' if b == 65536 else ''}", (b, lb - k + 1),
        lambda: (run(acc_k.copy_(acc0)),),
        lambda: (run(acc_p.copy_(acc0), plain=True),),
        reps=10, bound=probe_acc_bound(feed[0], k, nt, in_read, in_read & (acc0 == 0), probed, hits, planes,
                                       sectors=rows_sectors(split)),
        extra={"k": k, "nt": nt, "lb": UID_CHUNK_LB, "chunk_gb": sum(p.numel() * 4 for p in planes) / 1e9,
               "bins": [lo, hi], "lanes_probed": int(probed.sum()), "split": split,
               "lanes_screened": split["b1"] + split["b2"], "lanes_set": int(hits.sum()),
               **probe_floor(planes[1].view(-1, 4), int(probed.sum()), seed + 4)},
    )


def fused_floors(fused, valid, rows: dict, seed: int) -> dict:
    """The fused probe's random-sector floors on its plane (probe_floor):
    `floor_ms`, two random 16 B rows a valid query; `floor_1row_ms`, one;
    `floor_mix_ms`, the mix the data needs, each valid query answered by its
    first row paying the one-row floor's share and every other the two-row
    one's (None without `rows`); with the rows' counts."""
    nv = int(valid.sum())
    two, one = probe_floor(fused, 2 * nv, seed), probe_floor(fused, nv, seed + 1)
    f = None if rows["row1"] is None or nv == 0 else rows["row1"] / nv
    return {**two, "floor_1row_ms": one["floor_ms"], "floor_1row_ms_by": one["floor_ms_by"],
            "floor_mix_ms": None if f is None else f * one["floor_ms"] + (1 - f) * two["floor_ms"],
            "rows_answered": rows, "row1_share": f}


def plant_fused(fused, h, lb: int, seed: int):
    """Store the first half of `h` in slot 0 of its first-choice bucket and
    the second half in slot 1 of its second-choice bucket (choice bit set),
    each with a random value in [1, 2^min(lb - 1, 20)), as the fused build
    lays keys out; returns the values (a later query wins a slot two share)."""
    import torch

    from krakenuniq_tpu_torch.db.hash_table import GOLDEN
    from krakenuniq_tpu_torch.ints import lsr, s64, u32_to_i32

    gen = torch.Generator(device=h.device).manual_seed(seed)
    vals = torch.randint(1, 1 << min(lb - 1, 20), h.shape, dtype=torch.int64, device=h.device, generator=gen)
    half = h.numel() // 2
    for part, choice in ((slice(0, half), 0), (slice(half, None), 1)):
        hc = h[part] * s64(int(GOLDEN)) if choice else h[part]
        bucket = lsr(hc, 64 - lb)
        word = (((hc & ((1 << (32 - lb)) - 1)) << (lb - 1)) | vals[part] | (choice << 31)) & 0xFFFFFFFF
        fused[bucket, 2 * choice] = u32_to_i32(lsr(hc << lb, 32))
        fused[bucket, 2 * choice + 1] = u32_to_i32(word)
    return vals


def phase_fallback_kernels(n: int = 8_500_000):
    """The fallback lookups' kernels against their plain versions:
    fused_probe on random fused planes of the phase-4 table's size (lb = 27:
    110,988,000 keys at load 0.6, 2.1 GB) and of the largest width (lb = 30,
    17.2 GB), each with n uniform queries, ~1% invalid, half of them planted;
    kmer_bins at the unit and span shapes on both feeds at k = 21 / nt = 7
    and k = 31 / nt = 12, 15, 31 (a window of one nt-mer) and 20 (the
    kernel's 8-byte values), and at long rows (LONG_KNT); bsearch_lookup on sorted planes of 4^10
    bins (a fifth of them empty) with out-of-range bins, invalid lanes and
    bin_start 0 and 12,345 (a shard's planes). Returns fused_probe's record
    at the phase-4 size."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_bins, kmer_bins_plain, kmer_bins_words, pack_input
    from krakenuniq_tpu_torch.db.hash_table import min_lb_for
    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain
    from krakenuniq_tpu_torch.lookup.xla_lookup import lookup_kmers, lookup_kmers_plain

    gen = torch.Generator(device="cuda").manual_seed(31)
    rec = None
    for lb in (min_lb_for(110_988_000, 0xFFFF), 30):
        fused = torch.randint(-(1 << 31), 1 << 31, (1 << lb, 4), dtype=torch.int32, device="cuda", generator=gen)
        h = random_hashes(n, gen)
        valid = torch.rand(n, device="cuda", generator=gen) >= 0.01
        vals = plant_fused(fused, h[: n // 2], lb, 37)
        rows = fused_rows(fused, h, valid, lb)
        r = check_kernel(
            f"fused_probe lb={lb}", (n,),
            lambda: (hash_lookup_kmers((fused,), h, valid),),
            lambda: (hash_lookup_plain((fused,), h, valid),),
            reps=10, bound=fused_bound(valid, rows, fused.numel() * 4),
            extra={"lb": lb, "table_gb": fused.numel() * 4 / 1e9, **fused_floors(fused, valid, rows, 41)},
        )
        got = hash_lookup_kmers((fused,), h, valid)[: n // 2]
        ok = valid[: n // 2]
        if float((got[ok] == vals[ok]).float().mean()) < 0.9:
            raise AssertionError(f"fused_probe lb={lb}: planted keys did not return their values")
        rec = rec or r
        del fused, h, valid, vals, got
        torch.cuda.empty_cache()

    for b in (4096, 65536):
        codes, ambig = front_inputs(b, 160, 43)
        words = pack_input(codes, ambig)[0]
        for k, nt in ((21, 7), (31, 12), (31, 15), (31, 31), (31, 20)):
            for feed, run in (("codes", lambda: kmer_bins(codes, k, nt)),
                              ("words", lambda: kmer_bins_words(words, k, nt))):
                check_kernel(
                    f"kmer_bins {feed} k={k} nt={nt}", (b, 160), run, lambda: kmer_bins_plain(codes, k, nt),
                    reps=10, bound=bins_bound(b, 160, k, nt, feed == "words"), extra={"k": k, "nt": nt},
                )
    # rows longer than a block stages (4,096 bases, or 2,048 for nt > 16),
    # cut into tiles; at w = 2 (k = 21 / nt = 20, k = 17 / nt = 16) a tile's
    # values pass 48 KB and the plan halves the tile
    codes, ambig = front_inputs(64, LONG_LB, 53, LONG_LENGTHS)
    words = pack_input(codes, ambig)[0]
    for k, nt in LONG_KNT:
        for feed, run in (("codes", lambda: kmer_bins(codes, k, nt)),
                          ("words", lambda: kmer_bins_words(words, k, nt))):
            check_kernel(
                f"kmer_bins {feed} long rows k={k} nt={nt}", (64, LONG_LB), run,
                lambda: kmer_bins_plain(codes, k, nt),
                reps=10, bound=bins_bound(64, LONG_LB, k, nt, feed == "words"), extra={"k": k, "nt": nt},
            )

    rng = np.random.default_rng(47)
    n_bins = 4 ** 10
    sizes = np.where(rng.random(n_bins) < 0.2, 0, rng.geometric(0.15, n_bins))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    keys = np.sort(rng.integers(0, 1 << 62, offsets[-1], dtype=np.int64))  # sorted overall, so within bins
    bin_of = np.repeat(np.arange(n_bins), sizes)
    m = 1_000_000
    pick = rng.integers(0, len(keys), m)
    q = keys[pick].copy()
    bins = bin_of[pick].copy()
    junk = rng.random(m) < 0.3  # a miss in a real bin
    q[junk] = rng.integers(0, 1 << 62, int(junk.sum()))
    far = rng.random(m) < 0.02  # bins below 0 or past the last after bin_start
    bins[far] = rng.choice(np.array([-3, -1, n_bins, n_bins + 7]), int(far.sum()))
    empty = rng.random(m) < 0.05
    bins[empty] = rng.choice(np.flatnonzero(sizes == 0), int(empty.sum()))
    valid = rng.random(m) >= 0.05
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    vals = t(rng.integers(-(1 << 31), 1 << 31, len(keys), dtype=np.int64).astype(np.int32))
    vals_dense = t(rng.integers(0, 2_400_000, len(keys)).astype(np.int32))
    for bs in (0, 12_345):
        k0 = int(offsets[bs])
        planes = (t(keys[k0:]), vals[k0:].contiguous(), vals_dense[k0:].contiguous(), t(offsets[bs:] - k0))
        qs, bns, vs = t(q), t(bins), t(valid)
        n_iter = max(1, int(np.ceil(np.log2(sizes.max() + 1))) + 1)
        check_kernel(
            f"bsearch_lookup bin_start={bs}", (m,),
            lambda: lookup_kmers(*planes, qs, bns, vs, n_iter, bs),
            lambda: lookup_kmers_plain(*planes, qs, bns, vs, n_iter, bs),
            reps=10, bound=bsearch_bound(planes, qs, bns, vs, n_iter, bs), extra={"n_iter": n_iter},
        )
    return rec


# bin sizes the words entry's random planes give some queried bins: empty,
# one key, a few hundred keys (bins of real reads hold ~35) and around
# 2^n_iter (n_iter 10 converges on 511 keys, not 512; the short n_iter 5 on 31)
WORDS_SIZES = (0, 1, 31, 32, 127, 128, 129, 300, 511, 512)


def words_planes(canon, bins, searched, n_bins: int, bin0: int, seed: int, planted: float = 0.5):
    """Sorted planes over the bins [bin0, bin0 + n_bins) (offsets relative to
    bin0, the planes' bin_start) from a feed's lanes: `planted` of the
    searched lanes in range give their canonical k-mer to their bin, every
    bin is topped up with junk keys to a geometric size (mean 6.7, a fifth
    of the bins empty), and 64 queried bins of each size in WORDS_SIZES take
    that size (their planted keys cut to it). Returns (keys int64, vals
    int32, vals_dense int32, offsets int64) on the feed's device."""
    import torch

    dev = canon.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = bins.reshape(-1) - bin0
    ok = searched.reshape(-1) & (b >= 0) & (b < n_bins)
    pick = ok & (torch.rand(b.shape, device=dev, generator=gen) < planted)
    pk, inv = torch.unique(canon.reshape(-1)[pick], return_inverse=True)
    pb = torch.zeros_like(pk)
    pb[inv] = b[pick]  # a k-mer has one minimizer bin
    size = torch.empty(n_bins, device=dev).geometric_(0.15, generator=gen).long()
    size[torch.rand(n_bins, device=dev, generator=gen) < 0.2] = 0
    queried = torch.unique(b[ok])
    menu = torch.tensor(WORDS_SIZES, device=dev)
    edge = queried[torch.randperm(queried.numel(), device=dev, generator=gen)[: 64 * len(WORDS_SIZES)]]
    fixed = torch.full((n_bins,), -1, dtype=torch.int64, device=dev)
    fixed[edge] = menu[torch.arange(edge.numel(), device=dev) % len(WORDS_SIZES)]
    order = torch.sort(pb, stable=True).indices
    pb, pk = pb[order], pk[order]
    rank = torch.arange(pb.numel(), device=dev) - torch.searchsorted(pb, pb)
    cap = fixed[pb]
    keep = (cap < 0) | (rank < cap)
    pb, pk = pb[keep], pk[keep]
    n_planted = torch.bincount(pb, minlength=n_bins)
    target = torch.where(fixed >= 0, fixed, n_planted + size)
    jb = torch.repeat_interleave(torch.arange(n_bins, device=dev), target - n_planted)
    jk = torch.randint(0, 1 << 62, (jb.numel(),), dtype=torch.int64, device=dev, generator=gen)
    keys, kb = torch.cat([pk, jk]), torch.cat([pb, jb])
    o = torch.sort(keys, stable=True).indices
    o = o[torch.sort(kb[o], stable=True).indices]
    offsets = torch.zeros(n_bins + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(target, 0)
    n = keys.numel()
    vals = torch.randint(1, 1 << 31, (n,), dtype=torch.int32, device=dev, generator=gen)
    vals_dense = torch.randint(1, 2_400_000, (n,), dtype=torch.int32, device=dev, generator=gen)
    return keys[o].contiguous(), vals, vals_dense, offsets


def phase_words_kernel():
    """bsearch_words (the binary search from the span route's packed words)
    against its plain version on random sorted planes made from the feed's
    own lanes (words_planes): the span shape [65536, 160] at k = 31, nt = 12
    over all 4^12 bins (~95M keys), with n_iter 10 and a short 5, bin_start
    0 and a shard from 12,345 that ends 5,000 bins short of the last (lanes
    out of range on both sides), the first database's pass and a later one
    (a seeded 30% of the lanes already set); rows of LONG_LB bases at (31,
    12) over all bins and at (31, 20) over a window of 2^24 bins from the
    smallest searched bin. Each record has the lanes searched and hit."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import (
        bsearch_words,
        bsearch_words_plain,
        kmer_bins_plain,
        pack_input,
        unpack_input,
    )
    from krakenuniq_tpu_torch.kmer import ops as kops

    cases = [  # b, lb, k, nt, bin_start, bins short of the end, n_iter, first
        (65536, 160, 31, 12, 0, 0, 10, True), (65536, 160, 31, 12, 0, 0, 5, True),
        (65536, 160, 31, 12, 12_345, 5_000, 10, True), (65536, 160, 31, 12, 0, 0, 10, False),
        (64, LONG_LB, 31, 12, 0, 0, 10, True), (64, LONG_LB, 31, 20, None, 0, 10, True),
        (8, LONG_READ_LB, 31, 12, 0, 0, 10, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(83)
    for i, (b, lb, k, nt, bs, short, n_iter, first) in enumerate(cases):
        lengths = {160: (150, 160, 0, k - 1, k, 100), LONG_LB: LONG_LENGTHS}.get(lb, LONG_READ_LENGTHS)
        codes, ambig = front_inputs(b, lb, 90 + i, lengths)
        cw, aw = pack_input(codes, ambig)
        lens = torch.from_numpy(np.resize(np.asarray(lengths, np.int32), b)).cuda()
        w = lb - k + 1
        canon, bins = kmer_bins_plain(unpack_input(cw, aw)[0], k, nt)
        in_read = torch.arange(w, device="cuda")[None, :] < (lens - (k - 1)).clamp(min=0)[:, None]
        searched = in_read & ~kops.window_any(unpack_input(cw, aw)[1], k)
        if bs is None:  # a window of the 2^40 bins at nt = 20
            bin0, n_all = int(bins[searched].min()), 1 << 24
        else:
            bin0, n_all = 0, 4 ** nt
        keys, vals, vals_dense, offsets = words_planes(canon, bins, searched, n_all, bin0, 85 + i)
        start = bin0 if bs is None else bs
        k0 = int(offsets[start - bin0])
        plane = (keys[k0:], vals[k0:], vals_dense[k0:],
                 (offsets[start - bin0: n_all - short + 1] - k0).contiguous(), start)
        t0 = td0 = None
        if not first:
            t0 = torch.where(torch.rand((b, w), device="cuda", generator=gen) < 0.3,
                             torch.randint(1, 1 << 30, (b, w), dtype=torch.int32, device="cuda", generator=gen), 0)
            td0 = torch.randint(0, 1 << 20, (b, w), dtype=torch.int32, device="cuda", generator=gen)
        # a later pass updates its planes in place: each form its own copies
        own = {} if first else {plain: (t0.clone(), td0.clone()) for plain in (False, True)}

        def run(plain):
            fn = bsearch_words_plain if plain else bsearch_words
            if first:
                return fn(plane, cw, aw, lens, k, nt, n_iter)
            t, td = own[plain]
            return fn(plane, cw, aw, lens, k, nt, n_iter, t.copy_(t0), td.copy_(td0))

        got = run(True)
        rb = bins - start
        rec = check_kernel(
            f"bsearch_words k={k} nt={nt} n_iter={n_iter} bin_start={start}" + ("" if first else " later"),
            (b, w), lambda: run(False), lambda: run(True), reps=10,
            bound=words_bound(cw, aw, lens, k, nt, plane, n_iter, t0),
            extra={"k": k, "nt": nt, "n_iter": n_iter, "bin_start": start, "n_bins": plane[3].numel() - 1,
                   "first": first, "keys": plane[0].numel(), "lanes_searched": int(searched.sum()),
                   "lanes_in_range": int((searched & (rb >= 0) & (rb < plane[3].numel() - 1)).sum()),
                   "lanes_hit": int((got[0] != 0).sum())},
        )
        if rec["lanes_hit"] == 0 or (bs and rec["lanes_in_range"] == rec["lanes_searched"]):
            raise AssertionError(f"bsearch_words case {i}: no hit, or no lane out of range: {rec}")
        del keys, vals, vals_dense, offsets, plane, canon, bins
    torch.cuda.empty_cache()


def probe_case(name, planes, h, valid, reps):
    """chd_probe against its plain version (check_kernel) with floor_ms;
    returns the kernel's output."""
    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain

    check_kernel(
        name, tuple(h.shape),
        lambda: (hash_lookup_kmers(planes, h, valid),),
        lambda: (hash_lookup_plain(planes, h, valid),),
        reps=reps, bound=probe_bound(valid), extra=probe_floor(planes[1], int(valid.sum()), 29),
    )
    return hash_lookup_kmers(planes, h.reshape(-1), valid.reshape(-1))


def counts_check(segs, t: int, reps: int, label: str = ""):
    """taxon_counts on one or two (ids, mask) segments, each into a zero
    int64 [t] accumulator: one segment through taxon_counts; two through
    taxon_counts_pair, one launch (a work unit's reads and k-mers), or, in
    a package without it, through two taxon_counts calls ("form" says
    which; device_ms sums a call's launches). library_ms: one bincount per
    segment, of the ids with masked lanes sent to an extra bin t."""
    import torch

    from krakenuniq_tpu_torch.classify import device_counters as dcm

    dev = segs[0][0].device
    zeros = lambda: [torch.zeros(t, dtype=torch.int64, device=dev) for _ in segs]
    pair = getattr(dcm, "taxon_counts_pair", None)
    if len(segs) == 1:
        form, run = "one segment", lambda: (dcm.taxon_counts(zeros()[0], *segs[0]),)
    elif pair is not None:
        form, run = "pair", lambda: pair(*(x for a, seg in zip(zeros(), segs) for x in (a, *seg)))
    else:
        form, run = "two calls", lambda: tuple(dcm.taxon_counts(a, *seg) for a, seg in zip(zeros(), segs))
    extra = {"form": form}
    if len(segs) == 1:
        extra["sort_boundary_ms"] = sort_boundary_ms(*segs[0], t, reps)
    return check_kernel(
        "taxon_counts" + label, (*(ids.numel() for ids, _ in segs), t), run,
        lambda: tuple(dcm.taxon_counts_plain(a, *seg) for a, seg in zip(zeros(), segs)),
        reps=reps, bound=counts_bound(segs, t),
        library=lambda: [torch.bincount(torch.where(m, ids, t).reshape(-1), minlength=t + 1) for ids, m in segs],
        extra=extra,
    )


def regmax_check(reg0, taxa, enc, lanes, lut, p: int, reps: int, label: str = ""):
    """hll_regmax into a copy of reg0 (the copy is part of every timing).
    library_ms is the scatter-max stage alone: one scatter_reduce_ ("amax")
    of precomputed int64 slots and uint8 ranks into the copy."""
    import torch

    from krakenuniq_tpu_torch.classify.device_counters import hll_ranks, hll_regmax, hll_regmax_plain

    sel = lanes.reshape(-1)
    rows = taxa.reshape(-1)[sel].long()
    if lut is not None:
        rows = lut[rows].long()
    idx, rank = hll_ranks(enc.reshape(-1)[sel], p)
    slot, rank = rows * reg0.shape[1] + idx, rank.to(torch.uint8)
    return check_kernel(
        "hll_regmax" + label, (taxa.numel(), reg0.shape[0], reg0.shape[1]),
        lambda: (hll_regmax(reg0.clone(), taxa, enc, lanes, lut, p),),
        lambda: (hll_regmax_plain(reg0.clone(), taxa, enc, lanes, lut, p),),
        reps=reps, bound=regmax_bound(lanes, slot),
        library=lambda: reg0.clone().view(-1).scatter_reduce_(0, slot, rank, reduce="amax"),
    )


def phase_counter_kernels(p: int = 12):
    """taxon_counts at one unit's lanes over the 503-id pool, at
    counts_mxu_exp's shape (8,520,000 zipf-1.5 ids, T = 504) and over the
    dense 2,400,503-id space; both counts of a unit in one call over the
    pool, over the dense space (zipf ids) and over T = 58,112 and 58,113
    (the two forms' edge), and on views off the 16-byte
    grid of ragged lengths; hll_regmax at one unit's planes and at 8.5M
    lanes (P = 503, m = 4096), as rows = ids and through a lut, and at the
    unit shape on its edge cases: one hot slot (every lane one row and one
    index), one hot row (every lane one taxon), registers pre-filled with
    0-40, p = 4 and p = 18, and flagged encodings with every stored value
    0-63."""
    import torch

    from krakenuniq_tpu_torch.utils.bits import encode_hash_32

    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(a).cuda()
    for n, n_ids, zipf in ((4096 * 130, 503, True), (8_520_000, 504, True),
                           (8_520_000, PAD_NODES + 503, False), (4096, 503, False)):
        ids = (rng.zipf(1.5, size=n) % n_ids) if zipf else rng.integers(0, n_ids, size=n)
        counts_check([(t(ids.astype(np.int32)), t(rng.random(n) < 0.9))], n_ids, reps=20)
    # both counts of one unit ([4096] reads, [4096, 130] k-mers, zipf-1.5):
    # over the 503-id pool, and over the dense 2.4M-id space with the pool's
    # ids scattered in it (the dense device-counter layout)
    prng = np.random.default_rng(12)
    scattered = np.sort(prng.choice(PAD_NODES + 503, 503, replace=False))
    scattered[0] = 0
    for label, n_ids, id_of in ((" unit pair", 503, np.arange(503)), (" dense zipf", PAD_NODES + 503, scattered)):
        segs = [(t(id_of[prng.zipf(1.5, size=shape) % 503].astype(np.int32)), t(prng.random(shape) < 0.9))
                for shape in ((4096,), (4096, 130))]
        counts_check(segs, n_ids, reps=20, label=label)
    # the same pair over T = 58,112, the most bins the shared-memory form
    # holds (227 KB), and 58,113, the least the global form takes: zipf-1.5
    # ids over the whole id space (a value pool of tens of thousands of ids)
    for n_ids in (58_112, 58_113):
        segs = [(t((prng.zipf(1.5, size=shape) % n_ids).astype(np.int32)), t(prng.random(shape) < 0.9))
                for shape in ((4096,), (4096, 130))]
        counts_check(segs, n_ids, reps=20, label=f" T={n_ids}")
    # views one lane off the 16-byte grid, of lengths 4k + 1 and 4k + 2: the
    # kernel's scalar head and tail
    segs = [(ids[1:], mask[1:]) for ids, mask in
            ((t((prng.zipf(1.5, size=n) % 503).astype(np.int32)), t(prng.random(n) < 0.9)) for n in (4098, 532_483))]
    counts_check(segs, 503, reps=10, label=" ragged")
    pool = 503
    encode = lambda n, pp: t(encode_hash_32(rng.integers(0, 1 << 64, size=n, dtype=np.uint64), pp).view(np.int32))
    zeros = lambda pp: torch.zeros((pool, 1 << pp), dtype=torch.uint8, device="cuda")
    for n in (4096 * 130, 8_520_000):
        taxa = t((rng.zipf(1.5, size=n) % pool).astype(np.int32))
        enc = encode(n, p)
        lanes = t(rng.random(n) < 0.9)
        regmax_check(zeros(p), taxa, enc, lanes, None, p, reps=20)
    # through a lut: the pool's rows spread over a 2.4M-id space
    ids = np.sort(rng.choice(PAD_NODES + 503, pool, replace=False))
    ids[0] = 0
    lut = np.zeros(PAD_NODES + 503, np.int32)
    lut[ids] = np.arange(pool, dtype=np.int32)
    u = 4096 * 130
    taxa = t(ids[rng.zipf(1.5, size=u) % pool].astype(np.int32))
    enc, lanes = enc[:u], lanes[:u]
    regmax_check(zeros(p), taxa, enc, lanes, t(lut), p, reps=20, label=" lut")
    # edge cases at the unit shape
    taxa = t((rng.zipf(1.5, size=u) % pool).astype(np.int32))
    hot = torch.full_like(taxa, 7)
    regmax_check(zeros(p), hot, torch.full_like(enc, int(enc[0])), lanes, None, p, reps=10, label=" hot slot")
    regmax_check(zeros(p), hot, enc, lanes, None, p, reps=10, label=" hot row")
    filled = t(rng.integers(0, 41, size=(pool, 1 << p), dtype=np.uint8))
    regmax_check(filled, taxa, enc, lanes, None, p, reps=10, label=" pre-filled")
    for pp in (4, 18):
        regmax_check(zeros(pp), taxa, encode(u, pp), lanes, None, pp, reps=10, label=f" p={pp}")
    stored = np.arange(u, dtype=np.uint32) % 64
    flagged = (rng.integers(0, 1 << 25, size=u, dtype=np.uint32) << 7) | (stored << 1) | 1
    regmax_check(zeros(p), taxa, t(flagged.view(np.int32)), lanes, None, p, reps=10, label=" flag values")


def stats_planes(b, w, n_units, ids, seed):
    """One update's sparse-stats inputs on the card: zipf-1.5 taxa drawn
    from `ids` (the most frequent first), random encodings on the five most
    frequent (they go dense in a unit), a few hundred distinct ones on the
    rest (they stay sparse), ~90% counted lanes, and rows split into
    n_units consecutive work units."""
    import torch

    rng = np.random.default_rng(seed)
    pick = (rng.zipf(1.5, size=(b, w)) - 1) % len(ids)
    taxa = np.asarray(ids)[pick].astype(np.int32)
    enc = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    tail = pick >= 5
    enc[tail] = (rng.integers(0, 300, size=int(tail.sum())).astype(np.uint32) << 7) | 3
    lanes = rng.random((b, w)) < 0.9
    unit = np.repeat(np.arange(n_units), -(-b // n_units))[:b]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return t(taxa), t(enc.view(np.int32)), t(lanes), t(unit.astype(np.int64))


def stats_check(label, taxa, enc, lanes, unit, p, cap, reps, by_op=False):
    """sparse_stats (the key build, torch.sort, then the stats kernels)
    against sparse_stats_core (the plain torch chain, its second sort
    included), on the whole buffer and both counts. device_ms is the stats
    kernels after the sort (RECORDS_PER_LAUNCH of the package under test);
    call_device_ms every card record of one wrapper call (the key build as
    a kernel or as torch ops, the sort, the stats), so that packages that
    build the keys differently compare the same work; sort_ms the
    torch.sort the wrapper calls, on the same keys (no PyTorch call
    computes the function: library_ms stays unset); with `by_op`, the
    call's card records by operation (`call_by_op`). The bound is the
    kernels' work after the sort (stats_bound)."""
    import torch

    from krakenuniq_tpu_torch.classify import sparse_exact as se

    run = lambda: se.sparse_stats(taxa, enc, lanes, unit, p, cap)
    _, n_p, n_e = run()
    keys = se._stats_keys(taxa, enc, lanes, unit) ^ se._SIGN
    n = taxa.numel()
    n_distinct = int(torch.unique(keys[keys != (se._PAD ^ se._SIGN)]).numel())
    n_rec = card_records(run)
    if n_rec is None:
        call_ms, call_by = queued_ms(run, reps), "events"
    else:
        call_ms, call_by = device_ms(run, "sparse_stats", reps, n_rec, symbols=("",))
    extra = {"p": p, "cap": cap, "units": int(unit.unique().numel()), "n_pairs": int(n_p),
             "n_events": int(n_e), "n_distinct_keys": n_distinct, "bound_of": "the kernels after the sort",
             "sort_ms": time_ms(lambda: torch.sort(keys, stable=True), max(3, reps // 4)),
             "call_device_ms": call_ms, "call_device_ms_by": call_by, "call_records": n_rec}
    if by_op:
        extra["call_by_op"] = device_ms_by_op(run, reps=5, top=12)
    return check_kernel(
        "sparse_stats" + label, tuple(taxa.shape), run,
        lambda: se.sparse_stats_core(taxa, enc, lanes, unit, p, cap), reps=reps,
        bound=stats_bound(n, n_distinct, min(cap, n)), extra=extra,
    )


def keys_check(label, taxa, enc, lanes, unit, reps):
    """sparse_keys (the key build alone, as sparse_stats launches it before
    its sort) against the torch ops it replaces; skipped, with a note, on a
    package whose sparse_stats builds the keys with torch ops."""
    from krakenuniq_tpu_torch.classify import sparse_exact as se

    if not hasattr(se, "sparse_keys"):
        log("this package builds sparse_stats' keys with torch ops (no sparse_keys kernel)")
        return None
    return check_kernel(
        "sparse_keys" + label, tuple(taxa.shape), lambda: (se.sparse_keys(taxa, enc, lanes, unit),),
        lambda: (se._stats_keys(taxa, enc, lanes, unit) ^ se._SIGN,), reps=reps,
        bound=keys_bound(*taxa.shape, unit.element_size()), extra={"unit_dtype": str(unit.dtype)},
    )


def dict_check(label, ids, calls, n_ids, cap, with_call, reps, plain_fn=None):
    """span_dict against span_dict_plain (the JAX package's sort, cumsum,
    searchsorted and scatter in torch), or `plain_fn` (ids outside [0, T),
    which span_dict_plain does not take); library_ms: torch.unique of the
    plane, sorted, with the inverse."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import span_dict, span_dict_plain

    run = lambda: span_dict(ids, calls, n_ids, cap, with_call)
    plain = lambda: (plain_fn or span_dict_plain)(ids, calls, n_ids, cap, with_call)
    drop = lambda out: tuple(x for x in out if x is not None)
    n_u = int(run()[0][-1])
    return check_kernel(
        "span_dict" + label, tuple(ids.shape), lambda: drop(run()), lambda: drop(plain()), reps=reps,
        bound=dict_bound(ids.numel(), calls.numel(), cap, with_call),
        library=lambda: torch.unique(ids, sorted=True, return_inverse=True),
        extra={"n_ids": n_ids, "cap": cap, "n_u": n_u, "with_call": with_call},
    )


def phase_dict_stats_kernels(p: int = 12):
    """The span counters' and the span dictionary's kernels, each against
    its plain version: sparse_stats at the unit [4096, 160] (one unit over
    the 503-id pool), at the span [65536, 130] with 17 units (pool ids, and
    dense ids scattered over the 2.4M-id space), on one giant group (every
    lane of a one-unit span one taxon), at the d == m/4 edge with and
    without a last duplicate (p = 6) and with a cap below the entry count;
    span_dict at the span over the 2.4M-id space with n_u below, at and
    above its capacity (ids 0 and T - 1 among them, calls remapped or not);
    taxon_counts (both counts in one launch) and hll_regmax (through a lut)
    at the span's lanes, over the pool and over the dense space."""
    import torch

    rng = np.random.default_rng(21)
    t_ids = PAD_NODES + 503
    pool = np.arange(503)
    dense = np.sort(rng.choice(t_ids, 503, replace=False))
    dense[0] = 0
    for label, (b, w, units, ids, cap) in {
        " unit": (4096, 160, 1, pool, 1 << 21), " span": (65536, 130, 17, pool, 1 << 21),
        " span dense": (65536, 130, 17, dense, 1 << 21),
    }.items():
        stats_check(label, *stats_planes(b, w, units, ids, b + units), p, cap, reps=10)
    taxa, enc, lanes, unit = stats_planes(65536, 130, 17, pool, 5)
    rec = stats_check(" span", taxa, enc, lanes, unit, p, 1 << 21, reps=3)
    stats_check(" cap below", taxa, enc, lanes, unit, p, (rec["n_pairs"] + rec["n_events"]) // 2, reps=3)
    zeros = torch.zeros_like(taxa)
    stats_check(" giant group", zeros, enc, torch.ones_like(lanes), torch.zeros_like(unit), p, 1 << 21, reps=3)
    # one unit's taxon 7 over three tiles of lanes (4096 each) and more, from
    # 900 encodings: it stays sparse (900 < m/4 = 1024) with 900 pairs
    dup = torch.from_numpy((rng.integers(0, 900, size=(128, 130)).astype(np.uint32) << 7 | 5).view(np.int32))
    rec = stats_check(" sparse across tiles", torch.full((128, 130), 7, dtype=torch.int32, device="cuda"),
                      dup.cuda(), torch.ones((128, 130), dtype=torch.bool, device="cuda"),
                      torch.zeros(128, dtype=torch.uint8, device="cuda"), p, 1 << 21, reps=3)
    if (rec["n_pairs"], rec["n_events"]) != (int(dup.unique().numel()), 0):
        raise AssertionError(f"sparse_stats across tiles: {rec['n_pairs']} pairs, {rec['n_events']} events")
    rec = stats_check(" no counted lane", taxa, enc, torch.zeros_like(lanes), unit, p, 1 << 21, reps=3)
    if (rec["n_pairs"], rec["n_events"]) != (0, 0):
        raise AssertionError(f"sparse_stats without counted lanes: {rec['n_pairs']}, {rec['n_events']}")
    for dt in (torch.uint8, torch.int32, torch.int64):
        keys_check(f" span {str(dt)[6:]}", taxa, enc, lanes, unit.to(dt), reps=10)
    for dup in (False, True):
        stream = np.arange(1, 17, dtype=np.uint32)
        if dup:
            stream = np.concatenate([stream, stream[:1]])
        one = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        rec = stats_check(f" edge dup={dup}", one(np.full((1, len(stream)), 3, np.int32)),
                          one(stream[None, :].view(np.int32)), one(np.ones((1, len(stream)), bool)),
                          one(np.zeros(1, np.int64)), 6, 4096, reps=3)
        if (rec["n_events"] == 1) != dup:
            raise AssertionError(f"sparse_stats threshold edge (dup={dup}): {rec['n_events']} events")

    b, w, cap = 65536, 130, 1 << 15
    for label, n_kinds in ((" below", 3000), (" at", cap), (" above", 40_000)):
        edge = [0, 31, 32, t_ids - 1]  # a word's first and last bit, the next word, T - 1 (T % 32 = 23)
        kinds = np.unique(np.concatenate([edge, rng.choice(np.arange(33, t_ids - 1), n_kinds - 4, replace=False)]))
        ids = kinds[(rng.zipf(1.3, size=(b, w)) - 1) % len(kinds)].astype(np.int32)
        ids.reshape(-1)[: len(kinds)] = kinds  # every kind occurs: n_u = n_kinds
        calls = kinds[rng.integers(0, len(kinds), size=b)].astype(np.int32)
        ti, tc = torch.from_numpy(ids).cuda(), torch.from_numpy(calls).cuda()
        for with_call in (True, False):
            rec = dict_check(label, ti, tc, t_ids, cap, with_call, reps=10)
        if rec["n_u"] != len(kinds):
            raise AssertionError(f"span_dict{label}: n_u {rec['n_u']} != {len(kinds)}")
    # a span's ids as phase 7 sees them: 0 and the 400 species at the top of
    # the dense space (chip_smoke's database puts them there), a few words
    # of the bitmap that every block marks
    kinds = np.concatenate([[0], np.arange(t_ids - 400, t_ids)])
    ids = kinds[(rng.zipf(1.3, size=(b, w)) - 1) % len(kinds)].astype(np.int32)
    calls = kinds[rng.integers(0, len(kinds), size=b)].astype(np.int32)
    dict_check(" clustered", torch.from_numpy(ids).cuda(), torch.from_numpy(calls).cuda(), t_ids, cap, True, reps=10)
    # ids outside [0, T) are no entry and remap to 0: held against the
    # bitmap mirror (span_dict_plain does not take them)
    from krakenuniq_tpu_torch.classify import device_step as ds

    if hasattr(ds, "span_dict_bitmap"):
        bad = ti.clone()
        bad.view(-1)[::97] = -5
        bad.view(-1)[1::89] = t_ids
        rec = dict_check(" outside [0, T)", bad, tc, t_ids, cap, True, reps=10, plain_fn=ds.span_dict_bitmap)

    # the counter kernels at the span's lanes ([65536] calls, [65536, 130]
    # k-mers), zipf-1.5: over the pool, and over the dense space with the
    # register rows through a lut
    lut = np.zeros(t_ids, np.int32)
    lut[dense] = np.arange(503, dtype=np.int32)
    for label, ids, n_ids, lt in ((" span pair", pool, 503, None), (" span dense pair", dense, t_ids, lut)):
        taxa, enc, lanes, _ = stats_planes(b, w, 17, ids, 9)
        calls = torch.from_numpy(ids[(rng.zipf(1.5, size=b) - 1) % 503].astype(np.int32)).cuda()
        valid = torch.from_numpy(rng.random(b) < 0.95).cuda()
        counts_check([(calls, valid), (taxa, lanes)], n_ids, reps=10, label=label)
        reg0 = torch.zeros((503, 1 << p), dtype=torch.uint8, device="cuda")
        regmax_check(reg0, taxa, enc, lanes, None if lt is None else torch.from_numpy(lt).cuda(), p, reps=10,
                     label=label.replace(" pair", ""))


def phase_gather_kernel(depth: int = 16):
    """row_gather at the probe tool's defaults (a 1 GiB table, 8,519,680
    random queries) for 16-byte rows (the CHD row) and 512-byte rows, and
    for 16-byte rows at one unit's 532,480 queries, each record with the
    launch the kernel's C entry reports (a package without that entry:
    depth only); out-of-range indices at S = 1 and 256 (zero rows);
    returns the first record."""
    import torch

    from krakenuniq_tpu_torch.tools import probe_gather as pg

    gen = torch.Generator(device="cuda").manual_seed(7)
    flat = torch.randint(-(1 << 31), 1 << 31, ((1 << 26) * 4,), dtype=torch.int32, device="cuda", generator=gen)
    geometry = getattr(pg, "gather_geometry", lambda *args: {})
    recs = []
    for rb, n in ((16, 8_519_680), (512, 8_519_680), (16, 4096 * 130)):
        table = flat.view(-1, rb // 4)
        q = torch.randint(0, table.shape[0], (n,), dtype=torch.int32, device="cuda", generator=gen)
        recs.append(check_kernel(
            f"row_gather {rb}B", (n, rb // 4),
            lambda: (pg.row_gather(table, q, depth),),
            lambda: (pg.row_gather_plain(table, q),),
            reps=10, bound=gather_bound(n, rb),
            library=lambda: table.index_select(0, q), extra={"depth": depth, **geometry(n, rb // 4, depth)},
        ))
    # indices outside [0, R) give zero rows, at both ends of the ring depths
    table = flat.view(-1, 4)
    q = torch.randint(-5, table.shape[0] + 5, (10_007,), dtype=torch.int32, device="cuda", generator=gen)
    q[:2] = torch.tensor([-1, table.shape[0]], dtype=torch.int32)
    ok = ((q >= 0) & (q < table.shape[0]))[:, None]
    for s in (1, 256):
        check_kernel(
            "row_gather out-of-range", (q.numel(), 4),
            lambda: (pg.row_gather(table, q, s),),
            lambda: (torch.where(ok, pg.row_gather_plain(table, q.clamp(0, table.shape[0] - 1)), 0),),
            reps=5, bound=gather_bound(q.numel(), 16), extra={"depth": s},
        )
    return recs[0]


def probe_check(db, keys, n_queries=8_500_000, seed=5):
    """chd_probe on the full-size table: half hits (random DB keys), half
    junk, ~1% invalid lanes; kernel == plain, and every valid hit finds its
    key's stored value."""
    import torch

    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain
    from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

    rng = np.random.default_rng(seed)
    half = n_queries // 2
    pick = rng.integers(0, len(keys), size=half)
    junk = rng.integers(0, 1 << 62, size=n_queries - half, dtype=np.uint64)
    q = np.concatenate([np.asarray(keys[pick]), junk])
    h = torch.from_numpy(murmur3_finalizer(q).view(np.int64)).cuda()
    valid = torch.from_numpy(rng.random(n_queries) >= 0.01).cuda()
    planes = db.hash_table
    rec = check_kernel(
        "chd_probe", (n_queries,),
        lambda: (hash_lookup_kmers(planes, h, valid),),
        lambda: (hash_lookup_plain(planes, h, valid),),
        reps=10, bound=probe_bound(valid), extra=probe_floor(planes[1], int(valid.sum()), 29),
    )
    got = hash_lookup_kmers(planes, h, valid)[:half].cpu().numpy()
    vd = db.vals_dense[pick]
    want = db.pool.pool_index(vd) if db.pool is not None else vd
    ok = valid[:half].cpu().numpy()
    if not np.array_equal(got[ok], want[ok]) or (got[~ok] != 0).any():
        raise AssertionError("chd_probe: a stored key did not return its value")
    return rec


# ------------------------------------------------------------------ phase 3


def phase_goldens():
    """The goldens through the span route, the Python host route
    (use_native=False) and --device-counters on both routes."""
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    for dbs, kraken_name, report_name in (
        (["."], "kraken.out", "report.tsv"),
        (["db_bact", "db_viral"], "kraken_hier.out", "report_hier.tsv"),
    ):
        for route, opts in (("span", {}), ("python", {"use_native": False}),
                            ("span", {"device_counters": True}),
                            ("python", {"device_counters": True, "use_native": False})):
            c = Classifier(
                [os.path.join(GOLDEN, d) for d in dbs],
                ClassifyOptions(print_progress=False, device="cuda", **opts),
            )
            if c.route != route:
                raise AssertionError(f"golden run with {opts} took the {c.route} route")
            kraken, report = io.StringIO(), io.StringIO()
            c.run([os.path.join(GOLDEN, "reads.fa")], kraken_fh=kraken)
            c.write_report(report)
            for got, name in ((kraken.getvalue(), kraken_name), (report.getvalue(), report_name)):
                with open(os.path.join(GOLDEN, name)) as f:
                    if got != f.read():
                        raise AssertionError(f"golden {name} differs on the card ({route} route, {opts})")
            if c.dev_counters is not None and c.dev_counters.tracker.overflows:
                raise AssertionError("golden run overflowed the sparse buffer")
            log(f"golden {kraken_name} + {report_name} ({route} route, {opts}): byte-equal")
    emit({"check": "goldens", "files": ["kraken.out", "report.tsv", "kraken_hier.out", "report_hier.tsv"],
          "routes": ["span", "python", "span + device_counters", "python + device_counters"], "equal": True})


def phase_uid_goldens() -> dict:
    """The UID golden (kraken_uid.out, the reference's --uid-mapping run)
    through the span route, the Python route, --device-counters on both and
    out of core at a budget of a quarter of the raw table (at least 2 chunk
    tables), each kraken output byte-equal to the golden and each report to
    the first run's; rows_probe launched by the resident runs and
    rows_probe_acc by the out-of-core one, chd_probe and chd_probe_acc by
    none. Returns the launches of the out-of-core run."""
    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.db.chunked import table_bytes
    from krakenuniq_tpu_torch.formats.kdb import read_header

    with open(os.path.join(GOLDEN, "kraken_uid.out")) as f:
        want = f.read()
    budget = table_bytes(read_header(os.path.join(GOLDEN, "uid_database.kdb")).key_ct, 0, True) // 4
    report0 = None
    launches = {}
    for label, route, opts in (("span", "span", {}), ("python", "python", {"use_native": False}),
                               ("span + device_counters", "span", {"device_counters": True}),
                               ("python + device_counters", "python", {"device_counters": True, "use_native": False}),
                               ("span, out of core", "span", {"preload_size": budget})):
        _kernels.reset_launches()
        c = Classifier([GOLDEN], ClassifyOptions(print_progress=False, device="cuda", **opts), uid_database=True)
        kraken, report = io.StringIO(), io.StringIO()
        c.run([os.path.join(GOLDEN, "reads.fa")], kraken_fh=kraken)
        with contextlib.redirect_stderr(io.StringIO()):  # the report names the uids it finds no taxon for
            c.write_report(report)
        report0 = report0 or report.getvalue()
        launches = dict(_kernels.LAUNCHES)
        ooc = "preload_size" in opts
        probe = "rows_probe_acc" if ooc else "rows_probe"
        if c.route != route or (ooc and (c._ooc is None or c._ooc[0].n_chunks < 2)):
            raise AssertionError(f"UID golden {label}: {c.route} route, out-of-core tables {c._ooc}")
        if not launches[probe] or launches["chd_probe"] or launches["chd_probe_acc"]:
            raise AssertionError(f"UID golden {label}: launches {launches}")
        if kraken.getvalue() != want or report.getvalue() != report0:
            raise AssertionError(f"UID golden {label}: kraken output or report differs on the card")
        log(f"UID golden kraken_uid.out ({label}): byte-equal, report equal; {probe} {launches[probe]}")
    emit({"check": "uid goldens", "files": ["kraken_uid.out"],
          "routes": ["span", "python", "span + device_counters", "python + device_counters", "span, out of core"],
          "ooc_budget": budget, "equal": True, "ooc_launches": launches})
    return launches


@contextlib.contextmanager
def forced_fallback(kind: str):
    """Make every table build fail as the tests make it fail: "fused" makes
    CHD placement fail at every width (build_hash_table's "auto" then builds
    the fused layout), "bsearch" makes the whole table build raise
    HashBuildError (build_device_db then keeps the sorted planes)."""
    from krakenuniq_tpu_torch.db import device_db, hash_table

    if kind == "fused":
        target, name, fake = hash_table, "_chd_place", lambda *a, **kw: None
    else:
        def fake(*a, **kw):
            raise hash_table.HashBuildError("build failure forced by chip_smoke")

        target, name = device_db, "build_hash_table"
    saved = getattr(target, name)
    setattr(target, name, fake)
    try:
        yield
    finally:
        setattr(target, name, saved)


_TAXONOMIES: dict = {}


@contextlib.contextmanager
def shared_taxonomy():
    """Within: the port's Classifier takes a taxDB whose bytes it has parsed
    before from the parse it made then (Taxonomy.from_taxdb_file keyed by
    the file's sha256): a new Taxonomy over the same tree arrays, with
    genome sizes of its own (a report adds its database's counts to them,
    once per counts file and Taxonomy). Phase 4's 2.4M-node taxDB takes ~20
    s to parse; phases 13, 7, 9, 10 and 8 parse it once (phase 14's build
    and phase 4 parse their own)."""
    import dataclasses
    import hashlib

    from krakenuniq_tpu_torch.classify import pipeline

    read_taxdb = pipeline.Taxonomy.__dict__["from_taxdb_file"]

    def shared(cls, path):
        with open(path, "rb") as f:
            key = hashlib.sha256(f.read()).hexdigest()
        if key not in _TAXONOMIES:
            _TAXONOMIES[key] = read_taxdb.__func__(cls, path)
        tax = _TAXONOMIES[key]
        return dataclasses.replace(tax, genome_size=tax.genome_size.copy(),
                                   genome_size_children=tax.genome_size_children.copy())

    pipeline.Taxonomy.from_taxdb_file = classmethod(shared)
    try:
        yield
    finally:
        pipeline.Taxonomy.from_taxdb_file = read_taxdb


def remove_port_caches(db_dir: str, kdb: str = "database.kdb") -> None:
    """Delete the port's table caches beside db_dir's kdb (never the JAX
    package's .ht/.htc files)."""
    for suffix in (".ht_torch", ".ht_dense_torch", ".htc_torch"):
        path = os.path.join(db_dir, kdb + suffix)
        if os.path.exists(path):
            os.unlink(path)


def phase_fallback_goldens() -> dict:
    """The goldens through the fused fallback and the bsearch fallback, on
    copies of the golden databases (the port's caches in the golden
    directory would otherwise answer the load): the single database and the
    db_bact + db_viral pair, span and Python routes, with and without
    --device-counters, each byte-equal. Returns the launches of each
    fallback's runs (counters reset just before them, read just after)."""
    import shutil

    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    root = os.path.join(ROOT, "krakenuniq_tpu_torch", "_build", "golden_copy")
    for d in (".", "db_bact", "db_viral"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for f in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
            shutil.copy(os.path.join(GOLDEN, d, f), os.path.join(root, d, f))
    launches = {}
    for kind in ("fused", "bsearch"):
        _kernels.reset_launches()
        for dbs, kraken_name, report_name in (
            (["."], "kraken.out", "report.tsv"),
            (["db_bact", "db_viral"], "kraken_hier.out", "report_hier.tsv"),
        ):
            for route, opts in (("span", {}), ("python", {"use_native": False}),
                                ("span", {"device_counters": True}),
                                ("python", {"device_counters": True, "use_native": False})):
                for d in dbs:
                    remove_port_caches(os.path.join(root, d))
                with forced_fallback(kind):
                    c = Classifier([os.path.join(root, d) for d in dbs],
                                   ClassifyOptions(print_progress=False, device="cuda", **opts))
                got_kind = ("bsearch" if c._cfg.lookup_mode == "bsearch"
                            else "fused" if all(len(db.hash_table) == 1 for db in c.dbs) else "chd")
                if c.route != route or got_kind != kind:
                    raise AssertionError(f"{kind} fallback with {opts}: {c.route} route, {got_kind} lookup")
                kraken, report = io.StringIO(), io.StringIO()
                c.run([os.path.join(GOLDEN, "reads.fa")], kraken_fh=kraken)
                c.write_report(report)
                for got, name in ((kraken.getvalue(), kraken_name), (report.getvalue(), report_name)):
                    with open(os.path.join(GOLDEN, name)) as f:
                        if got != f.read():
                            raise AssertionError(f"golden {name} differs through the {kind} fallback ({opts})")
        launches[kind] = dict(_kernels.LAUNCHES)
        want = ("fused_probe",) if kind == "fused" else ("kmer_bins", "bsearch_lookup", "bsearch_words")
        if any(launches[kind][n] == 0 for n in want) or launches[kind]["chd_probe"]:
            raise AssertionError(f"{kind} fallback goldens: launches {launches[kind]}")
        log(f"goldens through the {kind} fallback (2 database sets x 4 runs): byte-equal; "
            f"launches {launches[kind]}")
    emit({"check": "fallback goldens", "fallbacks": ["fused", "bsearch"],
          "files": ["kraken.out", "report.tsv", "kraken_hier.out", "report_hier.tsv"],
          "routes": ["span", "python", "span + device_counters", "python + device_counters"], "equal": True,
          "launches": launches})
    return launches


# ------------------------------------------------------------------ phase 4


def demo_db_dir(n_species, genome_len, k, nt, pad_nodes, ballast, seed=7) -> str:
    """The synthetic database's directory under the port's _build/."""
    return os.path.join(ROOT, "krakenuniq_tpu_torch", "_build",
                        f"demo_db_{n_species}_{genome_len}_{k}_{nt}_{pad_nodes}_{ballast}_{seed}")


def ensure_db_dir(n_species, genome_len, k, nt, pad_nodes, ballast, seed=7):
    """Build-or-reuse the synthetic reference-layout database directory."""
    from krakenuniq_tpu_torch.formats import write_index, write_kdb
    from krakenuniq_tpu_torch.utils.demo import make_demo_db

    db_dir = demo_db_dir(n_species, genome_len, k, nt, pad_nodes, ballast, seed)
    genomes_npz = os.path.join(db_dir, "genomes.npz")
    if os.path.exists(genomes_npz):
        z = np.load(genomes_npz, allow_pickle=True)
        log(f"database reused: {db_dir}")
        return db_dir, z["genomes"].item(), 0.0
    t = time.time()
    os.makedirs(db_dir, exist_ok=True)
    keys, vals, offsets, tax, genomes = make_demo_db(
        n_species=n_species, genome_len=genome_len, k=k, nt=nt, seed=seed,
        species_base=10_000_000, pad_nodes=pad_nodes, ballast_keys=ballast,
    )
    log(f"database generated: {len(keys)} keys in {time.time() - t:.1f}s")
    write_kdb(os.path.join(db_dir, "database.kdb"), keys, vals, k=k)
    write_index(os.path.join(db_dir, "database.idx"), nt, np.asarray(offsets, dtype=np.uint64))
    tax.write_taxdb(os.path.join(db_dir, "taxDB"))
    np.savez(genomes_npz + ".tmp.npz", genomes=np.array(genomes, dtype=object))
    os.replace(genomes_npz + ".tmp.npz", genomes_npz)
    synth_s = time.time() - t
    log(f"database synthesised and written in {synth_s:.1f}s")
    return db_dir, genomes, synth_s


def write_reads(path, genomes, n_reads, read_len=150, seed=3):
    """zipf-1.5 species abundance, as the JAX bench draws it; each read id
    carries its true species."""
    rng = np.random.default_rng(seed)
    sids = list(genomes)
    wts = 1.0 / np.arange(1, len(sids) + 1, dtype=np.float64) ** 1.5
    gsel = np.searchsorted(np.cumsum(wts) / wts.sum(), rng.random(n_reads))
    glen = len(genomes[sids[0]])
    starts = rng.integers(0, glen - read_len, size=n_reads)
    with open(path, "w") as f:
        for i in range(n_reads):
            sid = sids[gsel[i]]
            s = starts[i]
            f.write(f">r{i}_{sid}\n{genomes[sid][s:s + read_len]}\n")


def ensure_reads(db_dir: str, genomes, n_reads: int | None = None) -> str:
    """Write-or-reuse phase 4's reads (N_READS by default) beside the
    database."""
    n_reads = N_READS if n_reads is None else n_reads
    reads_path = os.path.join(db_dir, f"reads_{n_reads}.fa")
    if not os.path.exists(reads_path):
        write_reads(reads_path + ".tmp", genomes, n_reads)
        os.replace(reads_path + ".tmp", reads_path)
    return reads_path


def uid_chain(species, n_sets: int, seed: int = 9):
    """uid_to_taxid.map's records for the species' singleton UIDs (UID i + 1:
    (species[i], 0)) and n_sets UIDs of 2-4 species, chained as the UID
    build chains them: each new set is an existing one of 1-3 species (its
    parent UID) plus one species, recorded as (added taxid, parent UID), and
    a set (sorted) that exists already is not recorded again. Returns the
    records and each UID's sorted set."""
    rng = np.random.default_rng(seed)
    chain = [(int(t), 0) for t in species]
    sets = [(int(t),) for t in species]
    known = set(sets)
    for _ in range(100 * n_sets):
        if len(chain) == len(species) + n_sets:
            break
        parent = int(rng.integers(1, len(chain) + 1))
        t = int(species[rng.integers(len(species))])
        new = tuple(sorted(sets[parent - 1] + (t,)))
        if len(new) > 4 or t in sets[parent - 1] or new in known:
            continue
        known.add(new)
        sets.append(new)
        chain.append((t, parent))
    if len(chain) < len(species) + n_sets:
        raise ValueError(f"{len(species)} species give no {n_sets} distinct sets of 2-4 in 100 draws a set")
    return chain, sets


def ensure_uid_db(db_dir: str, genomes) -> float:
    """Write-or-reuse the UID database over all of phase 4's keys beside
    phase 4's database (write_uid_db over its kdb; --uid-ooc-only measures
    on it); returns the seconds it took (0 when reused)."""
    from krakenuniq_tpu_torch.formats import read_kdb

    if all(os.path.exists(os.path.join(db_dir, f)) for f in ("uid_database.kdb", "uid_to_taxid.map")):
        return 0.0
    t = time.time()
    hdr, keys, vals = read_kdb(os.path.join(db_dir, "database.kdb"))
    write_uid_db(db_dir, keys, vals, hdr.k, genomes)
    return time.time() - t


def uid_genome_dir(db_dir: str) -> str:
    """Phase 13's UID database directory beside phase 4's database."""
    return f"{db_dir}_uid_genome"


def ensure_uid_genome_db(db_dir: str, genomes) -> float:
    """Write phase 13's UID database (write_uid_db over phase 4's genome
    keys, into uid_genome_dir) from phase 4's kdb and index when no
    synthesis process wrote it; returns the seconds it took."""
    from krakenuniq_tpu_torch.formats import read_index, read_kdb

    t = time.time()
    hdr, keys, vals = read_kdb(os.path.join(db_dir, "database.kdb"))
    _, _, offsets = read_index(os.path.join(db_dir, "database.idx"))
    write_uid_db(uid_genome_dir(db_dir), keys, vals, hdr.k, genomes, offsets=offsets,
                 taxdb=os.path.join(db_dir, "taxDB"))
    return time.time() - t


def write_uid_db(out_dir: str, keys, vals, k: int, genomes, offsets=None, taxdb: str | None = None,
                 seed: int = 9) -> None:
    """Write a UID database over phase 4's keys in their order
    (`uid_database.kdb` and `uid_to_taxid.map`): genome keys (the genomes'
    canonical k-mers, found through a byte map of their murmur hashes, then
    exactly) take their species' singleton UID, and UID_SET_SHARE of them a
    UID whose set holds their species; ballast keys take uniform UIDs.
    `vals` are phase 4's values: each key's species. Without `offsets` every
    key is written (database.kdb, database.idx and taxDB are phase 4's, in
    the same directory); with phase 4's index `offsets`, only the genome
    keys, with the LCA database over them (database.kdb: their values), the
    index cut to them (database.idx) and taxDB linked to `taxdb`: phase
    13's database, whose genome keys hold the same UIDs as in the whole
    one."""
    from krakenuniq_tpu_torch.formats import write_index, write_kdb
    from krakenuniq_tpu_torch.utils.bits import canonical_representation, murmur3_finalizer
    from krakenuniq_tpu_torch.utils.demo import _host_pack_windows

    t = time.time()
    kdb, map_path = os.path.join(out_dir, "uid_database.kdb"), os.path.join(out_dir, "uid_to_taxid.map")
    species = np.asarray(sorted(genomes), dtype=np.uint32)
    chain, sets = uid_chain(species, N_UID_SETS, seed)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = np.stack([lut[np.frombuffer(genomes[int(sid)].encode(), np.uint8)] for sid in species])
    gk = np.sort(canonical_representation(_host_pack_windows(codes, k).reshape(-1), k))
    mark = np.zeros(1 << 28, np.uint8)
    mark[(murmur3_finalizer(gk) >> np.uint64(36)).astype(np.int64)] = 1
    cand = np.flatnonzero(mark[(murmur3_finalizer(keys) >> np.uint64(36)).astype(np.int64)])
    del mark
    pos = np.minimum(np.searchsorted(gk, keys[cand]), len(gk) - 1)
    genome = np.zeros(len(keys), bool)
    genome[cand[gk[pos] == keys[cand]]] = True
    rng = np.random.default_rng(seed)
    sp = np.searchsorted(species, vals)  # each key's species index (its LCA value is its species)
    uvals = np.where(genome, sp + 1, 0).astype(np.uint32)
    ballast = ~genome
    uvals[ballast] = rng.integers(1, len(chain) + 1, size=int(ballast.sum()))
    holding = [[] for _ in species]
    for uid, members in enumerate(sets[len(species):], start=len(species) + 1):
        for m in members:
            holding[int(np.searchsorted(species, m))].append(uid)
    pick = np.flatnonzero(genome & (rng.random(len(keys)) < UID_SET_SHARE))
    pick_sp = sp[pick]
    for i, uids in enumerate(holding):
        sel = pick[pick_sp == i]
        if uids and len(sel):
            uvals[sel] = np.asarray(uids, np.uint32)[rng.integers(0, len(uids), size=len(sel))]
    os.makedirs(out_dir, exist_ok=True)
    n_written = len(keys)
    if offsets is not None:
        # the genome keys in their order: each bin's offset counts the
        # genome keys before it
        before = np.concatenate(([0], np.cumsum(genome, dtype=np.int64)))
        sub = before[np.asarray(offsets, dtype=np.int64)].astype(np.uint64)
        nt = (len(offsets) - 1).bit_length() // 2
        write_index(os.path.join(out_dir, "database.idx.tmp"), nt, sub)
        os.replace(os.path.join(out_dir, "database.idx.tmp"), os.path.join(out_dir, "database.idx"))
        if not os.path.lexists(os.path.join(out_dir, "taxDB")):
            os.symlink(taxdb, os.path.join(out_dir, "taxDB"))
        keys, uvals = keys[genome], uvals[genome]
        n_written = len(keys)
        # the LCA database over the same keys (the report's database counts)
        write_kdb(os.path.join(out_dir, "database.kdb.tmp"), keys, np.asarray(vals)[genome], k=k)
        os.replace(os.path.join(out_dir, "database.kdb.tmp"), os.path.join(out_dir, "database.kdb"))
    write_kdb(kdb + ".tmp", keys, uvals, k=k)
    np.asarray(chain, dtype="<u4").reshape(-1).tofile(map_path + ".tmp")
    os.replace(map_path + ".tmp", map_path)
    os.replace(kdb + ".tmp", kdb)
    log(f"UID database written: {n_written} keys of phase 4's ({int(genome.sum())} genome keys), {len(chain)} "
        f"UIDs in {time.time() - t:.1f}s")


def _synth_child(queue, shape, n_reads: int) -> None:
    """The body of start_synthesis' first process: phase 4's database
    (shape: species, genome length, pad nodes, ballast keys) and reads; puts
    (synthesis s, reads file s) on the queue."""
    n_species, genome_len, pad_nodes, ballast = shape
    db_dir, genomes, synth_s = ensure_db_dir(n_species, genome_len, 31, 12, pad_nodes, ballast)
    t = time.time()
    ensure_reads(db_dir, genomes, n_reads)
    queue.put((synth_s, time.time() - t))


def _uid_child(queue, shape) -> None:
    """The body of start_synthesis' second process: phase 4's keys and
    values made again in memory (make_demo_db is deterministic) and phase
    13's UID database (phase 4's genome keys) written from them beside
    phase 4's directory, while the first process writes phase 4's database;
    then phase 14's library and taxonomy dumps (write_build_inputs); puts
    its seconds."""
    from krakenuniq_tpu_torch.utils.demo import make_demo_db

    t = time.time()
    n_species, genome_len, pad_nodes, ballast = shape
    keys, vals, offsets, tax, genomes = make_demo_db(
        n_species=n_species, genome_len=genome_len, k=31, nt=12, seed=7, species_base=10_000_000,
        pad_nodes=pad_nodes, ballast_keys=ballast)
    db_dir = demo_db_dir(n_species, genome_len, 31, 12, pad_nodes, ballast)
    write_uid_db(uid_genome_dir(db_dir), keys, vals, 31, genomes, offsets=offsets,
                 taxdb=os.path.join(db_dir, "taxDB"))
    del keys, vals, offsets
    write_build_inputs(build_dir(n_species, genome_len, pad_nodes), genomes, tax)
    queue.put(time.time() - t)


def start_synthesis():
    """Start phase 4's database and reads synthesis (host numpy, ~110 s) in a
    child process, and phase 13's UID database (its own make_demo_db, then
    the genome keys' UIDs) and phase 14's inputs in a second, so that both
    overlap phases 2 and 3 on the card;
    phase_main waits for the first (finish_synthesis), phase_uid for the
    second (finish_uid_synthesis). Returns ((process, queue), (process,
    queue))."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    shape = (N_SPECIES, GENOME_LEN, PAD_NODES, BALLAST)
    out = []
    for target, args in ((_synth_child, (shape, N_READS)), (_uid_child, (shape,))):
        queue = ctx.Queue()
        # daemonic: ended at the interpreter's exit if nothing waits for it
        proc = ctx.Process(target=target, args=(queue, *args), daemon=True)
        proc.start()
        out.append((proc, queue))
    return tuple(out)


def _child_next(child, what: str):
    """The next item a child process puts on its queue; raises as soon as
    the process has died without putting it (or after 1,800 s)."""
    from queue import Empty

    proc, queue = child
    deadline = time.time() + 1800
    while True:
        try:
            return queue.get(timeout=5)
        except Empty:
            if not proc.is_alive() or time.time() > deadline:
                proc.join(timeout=10)
                raise RuntimeError(f"{what} failed (exit code {proc.exitcode})")


def _synth_result(child, what: str = "a database synthesis process"):
    """What one of start_synthesis' (or phase 14's) processes puts last on
    its queue, after the process has ended; raises as soon as the process
    has died without putting it (or after 1,800 s)."""
    proc, _ = child
    result = _child_next(child, what)
    proc.join(timeout=60)
    if proc.is_alive() or proc.exitcode != 0:
        raise RuntimeError(f"{what} did not end cleanly (exit code {proc.exitcode})")
    return result


def finish_synthesis(synth) -> tuple[float, float]:
    """Wait for phase 4's database and reads (start_synthesis' first
    process); returns (synthesis s, reads file s)."""
    return _synth_result(synth[0])


def finish_uid_synthesis(synth) -> float:
    """Wait for phase 13's UID database (start_synthesis' second process);
    returns its seconds."""
    return _synth_result(synth[1])


def phase_main(reps: int, synth=None):
    import torch

    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.classify.device_step import (
        kmer_front_packed,
        kmer_front_words,
        pack_runs,
        pack_runs_plain,
    )
    from krakenuniq_tpu_torch.formats import read_kdb
    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain
    from krakenuniq_tpu_torch.taxonomy.resolve import _scores_plain, scores

    k, nt = 31, 12
    if synth is not None:  # started beside phases 2-3
        t = time.time()
        synth_s, reads_s = finish_synthesis(synth)
        log(f"waited {time.time() - t:.1f}s for the synthesis process ({synth_s:.1f}s of synthesis)")
    db_dir, genomes, synth_here = ensure_db_dir(N_SPECIES, GENOME_LEN, k, nt, PAD_NODES, BALLAST)
    t = time.time()
    reads_path = ensure_reads(db_dir, genomes)
    if synth is None:
        synth_s, reads_s = synth_here, time.time() - t

    # the directory outlives the call that built it: drop the port's table
    # caches so that the first load is a cold build
    remove_port_caches(db_dir)
    t = time.time()
    c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda"))
    load_s = time.time() - t
    db = c.dbs[0]
    log(f"loaded in {load_s:.1f}s {db.timings}; lr={db.hash_lb}, {db.table_bytes / 1e9:.3f} GB table")
    if c.route != "span":
        raise AssertionError(f"phase 4 takes the {c.route} route, not the span route")
    if db.timings.get("cache") != "miss" or not os.path.exists(os.path.join(db_dir, "database.kdb.ht_torch")):
        raise AssertionError(f"the cold load wrote no table cache: {db.timings}")
    # (the warm load of a cached table is checked in phase 14, on the built
    # database: a warm reload of this one took ~41 s)
    _, keys, _ = read_kdb(os.path.join(db_dir, "database.kdb"))
    probe_check(db, keys)
    del keys

    out_path = os.path.join(db_dir, "kraken.out")
    report_path = os.path.join(db_dir, "report.tsv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t = time.time()
    with open(out_path, "w") as kf:
        c.run([reads_path], kraken_fh=kf)
    classify_s = time.time() - t
    with open(report_path, "w") as rf:
        c.write_report(rf)
    torch.cuda.synchronize()
    run_s = time.time() - t
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {c.total_sequences} reads in {run_s:.1f}s, {c.n_spans} spans, launches {launches}")
    missing = [n for n in ("scores", "kmer_front", "chd_probe", "pack_runs") if launches[n] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    if c.n_units or launches["pack_runs"] != c.n_spans:
        raise AssertionError(f"main path ran {c.n_units} Python-route units; "
                             f"{launches['pack_runs']} pack_runs launches for {c.n_spans} spans")

    # outputs: one line per read, calls against each read's true species
    n_lines = n_right = n_class = 0
    with open(out_path) as f:
        for line in f:
            st, rid, call = line.split("\t", 3)[:3]
            n_lines += 1
            n_class += st == "C"
            n_right += int(call) == int(rid.rsplit("_", 1)[1])
    with open(report_path) as f:
        report_rows = sum(1 for _ in f)
    if n_lines != N_READS or n_right < 0.99 * N_READS or report_rows < 3:
        raise AssertionError(
            f"main path output wrong: {n_lines} lines, {n_right} right calls, {report_rows} report rows"
        )

    # one full span: the kernels' step against the same step forced to the
    # plain versions
    kind, buf, offs, _, _ = next(c._iter_native_spans(reads_path))
    if kind != "span":
        raise AssertionError(f"the first chunk of the reads took the {kind} path")
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    out_k = c._span_step(codes_w, ambig_w, lengths_np)
    out_p = c._span_step(codes_w, ambig_w, lengths_np, plain=True)
    torch.cuda.synchronize()
    for key in out_p:
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"span: kernel step differs from plain step in {key!r}")
    b, lbw = codes_w.shape
    lb = 16 * lbw
    log(f"span [{b}, {lb}] ({len(offs)} reads): kernel step == plain step")

    # each kernel at this span's main-path inputs
    cw = torch.from_numpy(codes_w.view(np.int32)).cuda()
    aw = torch.from_numpy(ambig_w.view(np.int32)).cuda()
    p = c._cfg.hll_p
    front = check_kernel(
        "kmer_front packed", (b, lb),
        lambda: kmer_front_words(cw, aw, k, p),
        lambda: kmer_front_packed(cw, aw, lb, k, p),
        reps=reps, bound=front_words_bound(b, lb, k),
    )
    hashes, _, kmer_ambig = kmer_front_words(cw, aw, k, p)
    w = lb - k + 1
    lengths = torch.from_numpy(lengths_np).cuda()
    n_kmers = torch.clamp(lengths - (k - 1), min=0)
    valid = torch.arange(w, device="cuda")[None, :] < n_kmers[:, None]
    search = valid & ~kmer_ambig
    planes = c._db_planes[0]
    probe = check_kernel(
        "chd_probe", (b, w),
        lambda: (hash_lookup_kmers(planes, hashes, search),),
        lambda: (hash_lookup_plain(planes, hashes, search),),
        reps=reps, bound=probe_bound(search), extra=probe_floor(planes[1], int(search.sum()), 29),
    )
    t_dense = out_k["taxa_dense"]
    hit = t_dense != 0
    rows = c._io[t_dense.long()]  # [B, W, 2]: the kernel reads both halves in place
    tins, touts = rows[..., 0], rows[..., 1]
    score = check_kernel(
        "scores", (b, w),
        lambda: (scores(tins, touts, hit),),
        lambda: (_scores_plain(tins, touts, hit),),
        reps=reps, bound=scores_bound(hit),
    )
    # the compact rows' inputs: the dense call and hit count of each read
    r = c._cfg_packed.max_runs
    call_dense = (out_k["packed"][:, r] >> 16) & 0xFFFF
    hits = hit.sum(dim=1, dtype=torch.int32)
    ambig = out_k["ambig"]
    rle = check_kernel(
        "pack_runs compact", (b, w),
        lambda: (pack_runs(t_dense, ambig, n_kmers, call_dense, hits, r, "compact"),),
        lambda: (pack_runs_plain(t_dense, ambig, n_kmers, call_dense, hits, r, "compact"),),
        reps=reps, bound=rle_bound(n_kmers, w, r + 1), extra={"max_runs": r},
    )
    if not torch.equal(pack_runs(t_dense, ambig, n_kmers, call_dense, hits, r, "compact"), out_k["packed"]):
        raise AssertionError("pack_runs on the span's planes differs from the step's packed rows")
    # the fused form the step launches: the rows and the HLL feed at once
    from krakenuniq_tpu_torch.classify import device_step as ds

    feed_check(ds, " span", t_dense, ambig, n_kmers, call_dense, hits, None, r, reps)
    rows_f, feed_f = pack_runs(t_dense, ambig, n_kmers, call_dense, hits, r, "compact", hll16=True)
    if not (torch.equal(rows_f, out_k["packed"]) and torch.equal(feed_f, out_k["hll_dense"])):
        raise AssertionError("fused pack_runs on the span's planes differs from the step's packed and hll_dense")
    # the span step's card time by operation (PERF.md: the rest beyond the
    # four kernels)
    by_op = device_ms_by_op(lambda: c._span_step(codes_w, ambig_w, lengths_np), reps=5)
    log(f"span step on the card: {by_op['busy_ms']} ms busy of {by_op['span_ms']} ms")
    n_ov = int(((out_k["packed"][: len(offs), r] & 0xFFFF) > r).sum())

    spans = max(c.n_spans, 1)
    emit({
        "phase": "main_path",
        "route": c.route,
        "db_keys": int(db.key_ct),
        "taxonomy_nodes": int(c.taxonomy.size),
        "pool_ids": int(db.pool.size) if db.pool is not None else None,
        "table_gb": db.table_bytes / 1e9,
        "synth_s": synth_s,
        "reads_file_s": reads_s,
        "load_s": load_s,
        "placement_s": db.timings.get("build_place"),
        "load_steps_s": db.timings,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        # run_s = classify_s (c.run: parse, spans) + the report (write_report)
        "classify_s": classify_s,
        "spans": c.n_spans,
        "span_shape": [b, lb],
        "overflow_rows_span0": n_ov,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "span_step_device_ms_by_op": by_op,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "classified": n_class,
        "calls_right": n_right,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
    })
    run = {"c": c, "reads": reads_path, "kraken": out_path, "report": report_path,
           "reads_per_s": c.total_sequences / run_s, "genomes": genomes, "synth": synth}
    return {"scores": score, "kmer_front": front, "chd_probe": probe, "pack_runs": rle}, launches, run


# ------------------------------------------------------------------ phase 5


def same_bytes(pairs) -> None:
    """Each (a, b) file pair holds the same bytes."""
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{os.path.basename(a)} differs from {os.path.basename(b)}")


def timed_run(c, reads, out_path, report_path):
    """Classifier.run and write_report with every launch counter reset just
    before and read just after: (run_s, classify_s, launches, peak bytes)."""
    import torch

    from krakenuniq_tpu_torch import _kernels

    card = torch.cuda.is_available()  # (phase 14 rehearses on the CPU too)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t = time.time()
    with open(out_path, "w") as kf:
        c.run([reads], kraken_fh=kf)
    classify_s = time.time() - t
    with open(report_path, "w") as rf:
        c.write_report(rf)
    if card:
        torch.cuda.synchronize()
    return time.time() - t, classify_s, dict(_kernels.LAUNCHES), torch.cuda.max_memory_allocated() if card else 0


def count_step_equal(c, codes, ambig, lengths, n_span, bounds) -> None:
    """One span's step with the counter update (classify_and_count_core)
    against the same forced to the plain versions, each on copies of the
    counters' state: the outputs, the state and the sparse buffer."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import classify_and_count_core

    dc = c.dev_counters
    results = []
    for plain in (False, True):
        state = [x.clone() for x in dc.state()]
        out, sp = classify_and_count_core(
            *state, dc.lut, c._db_planes, c._taxid_table, c._io, c._parent, c._root_dense,
            c._upload(codes.view(np.int32)), c._upload(ambig.view(np.int32)), c._upload(lengths), n_span,
            c._upload(c._unit_id_rows(bounds, codes.shape[0])), c._cfg_packed, dc.p, dc.sparse_cap,
            dc.counts_only, plain=plain,
        )
        results.append((out, state, sp))
    torch.cuda.synchronize()
    (ko, ks, kp), (po, ps, pp) = results
    for key in po:
        if not torch.equal(ko[key], po[key]):
            raise AssertionError(f"span: kernel count step differs from plain in {key!r}")
    for name, g, w in zip(("registers", "kmer_counts", "read_counts", "sparse buf", "n_pairs", "n_events"),
                          (*ks, *kp), (*ps, *pp)):
        if not torch.equal(g, w):
            raise AssertionError(f"span: kernel count step differs from plain in {name}")


def span_planes(c, codes, ambig, lengths, bounds):
    """The counters' planes of one span (taxa_dense, enc, hll_lanes,
    call_dense) and its per-row unit ids, on the card."""
    import dataclasses

    cfg = dataclasses.replace(c._cfg_packed, outputs=("taxa_dense", "enc", "hll_lanes", "call_dense"))
    out = c._span_step(codes, ambig, lengths, cfg=cfg)
    return out, c._upload(c._unit_id_rows(bounds, codes.shape[0]))


def phase_span_counters(run4, reps: int):
    """--device-counters on the span route, on phase 4's loaded database and
    reads: byte-equal to phase 4, each span one launch of each kernel of
    the step and the update, no Python-route unit, no sparse overflow; one
    span's fused step against the plain one; the counter kernels at that
    span's planes."""
    import torch

    from krakenuniq_tpu_torch.classify import Classifier

    c = Classifier.with_shared_db(run4["c"], device_counters=True)
    dc = c.dev_counters
    if c.route != "span" or "hll_dense" in c._cfg_packed.outputs:
        raise AssertionError(f"phase 5 takes the {c.route} route with outputs {c._cfg_packed.outputs}")
    if dc.host_stats or dc.sparse_cap == 0 or dc.lut is not None:
        raise AssertionError("phase 5 should run the pool layout with device sparse stats")
    db_dir = os.path.dirname(run4["kraken"])
    out_path, report_path = os.path.join(db_dir, "kraken_dcs.out"), os.path.join(db_dir, "report_dcs.tsv")
    run_s, classify_s, launches, peak = timed_run(c, run4["reads"], out_path, report_path)
    log(f"span counters: {c.total_sequences} reads in {run_s:.1f}s, {c.n_spans} spans, launches {launches}")
    per_span = ("sparse_keys", "sparse_stats", "taxon_counts", "hll_regmax", "pack_runs", "kmer_front", "chd_probe",
                "scores")
    if c.n_units or c.n_spans == 0 or any(launches[k] != c.n_spans for k in per_span):
        raise AssertionError(f"span counters: {c.n_units} Python-route units, {c.n_spans} spans, "
                             f"launches {launches}")
    if dc.tracker.overflows:
        raise AssertionError(f"{dc.tracker.overflows} sparse-buffer overflows: host fallback taken")
    same_bytes(((out_path, run4["kraken"]), (report_path, run4["report"])))
    log("span counters kraken output and report: byte-equal to phase 4's")

    kind, buf, offs, bounds, _ = next(c._iter_native_spans(run4["reads"]))
    codes, ambig, lengths = c._encode_span(buf, offs)
    count_step_equal(c, codes, ambig, lengths, len(offs), bounds)
    b, w = codes.shape[0], 16 * codes.shape[1] - c.k + 1
    log(f"span [{b}, {w}] ({len(offs)} reads, {len(bounds) - 1} units): kernel count step == plain")
    planes, unit = span_planes(c, codes, ambig, lengths, bounds)
    taxa, enc, lanes = planes["taxa_dense"], planes["enc"], planes["hll_lanes"]
    row_valid = torch.arange(b, device="cuda") < len(offs)
    stats = stats_check(" phase-5 span", taxa, enc, lanes, unit, dc.p, dc.sparse_cap, reps=reps // 5, by_op=True)
    keys = keys_check(" phase-5 span", taxa, enc, lanes, unit, reps)
    counts = counts_check([(planes["call_dense"], row_valid), (taxa, lanes)], dc.n_taxa, reps, " phase-5 span pair")
    regmax = regmax_check(torch.zeros_like(dc.reg), taxa, enc, lanes, None, dc.p, reps, " phase-5 span")
    t = time.time()
    c.finalized_counts()
    finalize_s = time.time() - t
    spans = max(c.n_spans, 1)
    emit({
        "phase": "span_counters",
        "route": c.route,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_phase4": run4["reads_per_s"],
        "classify_s": classify_s,
        "finalize_s": finalize_s,
        "spans": c.n_spans,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "sparse_entries_per_span": dc.sparse_entries / spans,
        "sparse_union": dc.tracker.n_union,
        "sparse_overflows": dc.tracker.overflows,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "equal_to_phase4": True,
    })
    return {"sparse_stats": stats, "sparse_keys": keys, "taxon_counts": counts, "hll_regmax": regmax}, launches


def phase_dense_ids(ref, reps: int, n_sub: int = 100_000):
    """value_pool=False on the built database of phase 14 (`ref`, its run of
    phase 4's reads; a reload: dense ids over the 2.4M-node taxonomy): the
    span route with the per-span taxon dictionary, byte-equal to that run
    (its kraken output is phase 4's), with one span step held against the
    plain one, its card time by operation and span_dict at its planes;
    then, on the first n_sub reads, a dictionary too small for any span
    (every span redispatched on the wide rows) and --device-counters under
    the dictionary, both byte-equal to the default-capacity run of the same
    reads."""
    import dataclasses

    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    db_dir = os.path.dirname(ref["kraken"])
    dense_cache = os.path.join(db_dir, "database.kdb.ht_dense_torch")
    if os.path.exists(dense_cache):  # a cold dense build
        os.unlink(dense_cache)
    t = time.time()
    c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda", value_pool=False))
    load_s = time.time() - t
    if c.dbs[0].timings.get("cache") != "miss":
        raise AssertionError(f"phase 7's load was not a cold build: {c.dbs[0].timings}")
    if c.route != "span" or not c._cfg_packed.local_dict or c._pool is not None:
        raise AssertionError("value_pool=False should take the span route with the span dictionary")
    out_path, report_path = os.path.join(db_dir, "kraken_dict.out"), os.path.join(db_dir, "report_dict.tsv")
    run_s, classify_s, launches, peak = timed_run(c, ref["reads"], out_path, report_path)
    log(f"span dictionary: {c.total_sequences} reads in {run_s:.1f}s, {c.n_spans} spans, launches {launches}")
    per_span = ("span_dict", "pack_runs", "kmer_front", "chd_probe", "scores")
    if c.n_units or c.dict_overflows or any(launches[k] != c.n_spans for k in per_span):
        raise AssertionError(f"span dictionary: {c.n_units} Python-route units, {c.dict_overflows} "
                             f"overflows, launches {launches} for {c.n_spans} spans")
    same_bytes(((out_path, ref["kraken"]), (report_path, ref["report"])))
    log("span dictionary kraken output and report: byte-equal to the reference run's")

    kind, buf, offs, bounds, _ = next(c._iter_native_spans(ref["reads"]))
    codes, ambig, lengths = c._encode_span(buf, offs)
    out_k = c._span_step(codes, ambig, lengths)
    out_p = c._span_step(codes, ambig, lengths, plain=True)
    torch.cuda.synchronize()
    for key in out_p:
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"dictionary span: kernel step differs from plain step in {key!r}")
    n_u = int(out_k["lut"][-1])
    by_op = device_ms_by_op(lambda: c._span_step(codes, ambig, lengths), reps=5)
    cfg = dataclasses.replace(c._cfg_packed, outputs=("taxa_dense", "call_dense"))
    planes = c._span_step(codes, ambig, lengths, cfg=cfg)
    rec = dict_check(" phase-7 span", planes["taxa_dense"], planes["call_dense"], c._taxid_table.shape[0],
                     c._cfg_packed.dict_capacity, True, reps)

    sub = os.path.join(db_dir, f"reads_{n_sub}.fa")
    if not os.path.exists(sub):
        with open(ref["reads"]) as f, open(sub + ".tmp", "w") as g:
            for i, line in enumerate(f):
                if i >= 2 * n_sub:
                    break
                g.write(line)
        os.replace(sub + ".tmp", sub)
    runs = {}
    for name, opts in (("default", {}), ("wide", {"dict_capacity": 64}), ("counters", {"device_counters": True})):
        ci = Classifier.with_shared_db(c, **opts)
        paths = (os.path.join(db_dir, f"kraken_sub_{name}.out"), os.path.join(db_dir, f"report_sub_{name}.tsv"))
        r_s, _, r_launches, _ = timed_run(ci, sub, *paths)
        runs[name] = {"paths": paths, "run_s": r_s, "reads_per_s": ci.total_sequences / r_s, "spans": ci.n_spans,
                      "dict_overflows": ci.dict_overflows, "launches": r_launches}
        if ci.n_units or (ci.dict_overflows == ci.n_spans) != (name == "wide") or ci.n_spans == 0:
            raise AssertionError(f"{name} run: {ci.n_units} units, {ci.dict_overflows} of {ci.n_spans} "
                                 "spans redispatched")
        if name == "counters" and (ci.dev_counters.tracker.overflows or ci.dev_counters.lut is None):
            raise AssertionError("counters under the dictionary: sparse overflow or no lut layout")
        if name != "default":
            same_bytes(zip(paths, runs["default"]["paths"]))
    log(f"{n_sub} reads: the wide redispatch and the counters under the dictionary equal the default run")
    spans = max(c.n_spans, 1)
    emit({
        "phase": "dense_ids",
        "route": c.route,
        "taxonomy_nodes": int(c.taxonomy.size),
        "dict_capacity": c._cfg_packed.dict_capacity,
        "load_s": load_s,
        "load_steps_s": c.dbs[0].timings,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_reference": ref["reads_per_s"],
        "classify_s": classify_s,
        "spans": c.n_spans,
        "n_u_span0": n_u,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "span_step_device_ms_by_op": by_op,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "equal_to_reference": True,
        "subset": {name: {k: v for k, v in r.items() if k != "paths"} for name, r in runs.items()},
    })
    del c
    torch.cuda.empty_cache()
    return rec, launches


# ------------------------------------------------------------------ phase 9


def phase_bsearch(ref, reps: int):
    """The binary-search fallback: the built database of phase 14 (`ref`,
    its run of phase 4's reads) loaded with the table build made to fail
    (its table caches removed first, so the load builds), every lookup a
    search of the sorted planes on the card (dense ids, so the span
    dictionary engages, as in phase 7); phase 4's reads through
    Classifier.run and write_report, byte-equal to `ref`'s run (its kraken
    output is phase 4's), with bsearch_words launched once per span, kmer_bins and
    bsearch_lookup never, and chd_probe never; one span step against the
    plain one; on that span's feed and the real planes, bsearch_words
    against its plain version, and the unpacked feed's pair, kmer_bins and
    bsearch_lookup, each against its plain version (bsearch_lookup with its
    random-sector floor of 2 + n_iter reads)."""
    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.classify.device_step import (
        _unpack_codes,
        bsearch_words,
        bsearch_words_plain,
        kmer_bins_plain,
        kmer_bins_words,
        kmer_front_words,
    )
    from krakenuniq_tpu_torch.lookup.xla_lookup import lookup_kmers, lookup_kmers_plain

    db_dir = os.path.dirname(ref["kraken"])
    remove_port_caches(db_dir)
    held = torch.cuda.memory_allocated()
    t = time.time()
    with forced_fallback("bsearch"):
        c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda"))
    load_s = time.time() - t
    db = c.dbs[0]
    planes = db.sorted_planes
    plane_bytes = {name: p.numel() * p.element_size() for name, p in zip(("keys", "vals", "vals_dense", "offsets"), planes)}
    log(f"bsearch fallback loaded in {load_s:.1f}s {db.timings}; sorted planes {plane_bytes}, "
        f"n_iter {c._cfg.n_iter}")
    if (c._cfg.lookup_mode != "bsearch" or db.hash_table is not None or c._pool is not None
            or not c._cfg_packed.local_dict or c.route != "span"):
        raise AssertionError("the forced fallback should search the sorted planes on the span route, "
                             "dense ids under the span dictionary")
    out_path, report_path = os.path.join(db_dir, "kraken_bsearch.out"), os.path.join(db_dir, "report_bsearch.tsv")
    run_s, classify_s, launches, peak = timed_run(c, ref["reads"], out_path, report_path)
    log(f"bsearch: {c.total_sequences} reads in {run_s:.1f}s, {c.n_spans} spans, launches {launches}")
    per_span = ("bsearch_words", "kmer_front", "scores", "pack_runs", "span_dict")
    off_path = ("kmer_bins", "bsearch_lookup", "chd_probe", "fused_probe")
    if c.n_units or any(launches[k] != c.n_spans for k in per_span) or any(launches[k] for k in off_path):
        raise AssertionError(f"bsearch: {c.n_units} Python-route units, launches {launches} for {c.n_spans} spans")
    same_bytes(((out_path, ref["kraken"]), (report_path, ref["report"])))
    log("bsearch kraken output and report: byte-equal to the reference run's")

    kind, buf, offs, _, _ = next(c._iter_native_spans(ref["reads"]))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    out_k = c._span_step(codes_w, ambig_w, lengths_np)
    out_p = c._span_step(codes_w, ambig_w, lengths_np, plain=True)
    torch.cuda.synchronize()
    for key in out_p:
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"bsearch span: kernel step differs from plain step in {key!r}")
    by_op = device_ms_by_op(lambda: c._span_step(codes_w, ambig_w, lengths_np), reps=5)
    b, lbw = codes_w.shape
    lb, k, nt = 16 * lbw, c.k, c.nt
    cw = torch.from_numpy(codes_w.view(np.int32)).cuda()
    aw = torch.from_numpy(ambig_w.view(np.int32)).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    n_iter = c._cfg.n_iter
    plane = (*planes, db.bin_start)
    words_rec = check_kernel(
        "bsearch_words", (b, lb - k + 1),
        lambda: bsearch_words(plane, cw, aw, lengths, k, nt, n_iter),
        lambda: bsearch_words_plain(plane, cw, aw, lengths, k, nt, n_iter),
        reps=reps, bound=words_bound(cw, aw, lengths, k, nt, plane, n_iter, None),
        extra={"k": k, "nt": nt, "n_iter": n_iter},
    )
    codes_u = _unpack_codes(cw)
    bins_rec = check_kernel(
        "kmer_bins words", (b, lb),
        lambda: kmer_bins_words(cw, k, nt),
        lambda: kmer_bins_plain(codes_u, k, nt),
        reps=reps, bound=bins_bound(b, lb, k, nt, True), extra={"k": k, "nt": nt},
    )
    canon, bins = kmer_bins_words(cw, k, nt)
    _, _, kmer_ambig = kmer_front_words(cw, aw, k, c._cfg.hll_p)
    w = lb - k + 1
    search = (torch.arange(w, device="cuda")[None, :] < (lengths - (k - 1)).clamp(min=0)[:, None]) & ~kmer_ambig
    keys_rows = planes[0][: planes[0].numel() // 2 * 2].view(torch.int32).view(-1, 4)
    floor = probe_floor(keys_rows, int(search.sum()), 53)
    floor = {"floor_ms": floor["floor_ms"] * (2 + n_iter), "floor_ms_by": floor["floor_ms_by"],
             "floor_reads_per_lane": 2 + n_iter}
    look_rec = check_kernel(
        "bsearch_lookup", (b, w),
        lambda: lookup_kmers(*planes, canon, bins, search, n_iter, db.bin_start),
        lambda: lookup_kmers_plain(*planes, canon, bins, search, n_iter, db.bin_start),
        reps=reps, bound=bsearch_bound(planes, canon, bins, search, n_iter, db.bin_start),
        extra={"n_iter": n_iter, **floor},
    )
    pair_ms = bins_rec["device_ms"] + look_rec["device_ms"]
    # the keys in the bin of each searched lane
    rb = bins[search] - db.bin_start
    sizes = (planes[3][rb + 1] - planes[3][rb]).double()
    bin_keys = {"mean": float(sizes.mean()), "median": float(sizes.median()), "p90": float(sizes.quantile(0.9)),
                "max": int(sizes.max()), "share_over_64": float((sizes > 64).double().mean())}
    log(f"bsearch span: bsearch_words {words_rec['device_ms']:.4f} ms against kmer_bins + bsearch_lookup "
        f"{pair_ms:.4f} ms of card")
    spans = max(c.n_spans, 1)
    emit({
        "phase": "bsearch",
        "route": c.route,
        "db_keys": int(db.key_ct),
        "taxonomy_nodes": int(c.taxonomy.size),
        "sorted_planes_bytes": plane_bytes,
        "sorted_planes_gb": sum(plane_bytes.values()) / 1e9,
        "n_iter": n_iter,
        "max_bin": db.max_bin,
        "load_s": load_s,
        "load_steps_s": db.timings,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_reference": ref["reads_per_s"],
        "classify_s": classify_s,
        "spans": c.n_spans,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k_: v / spans for k_, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "span_step_device_ms_by_op": by_op,
        "searched_lane_bin_keys": bin_keys,
        "bsearch_words_device_ms": words_rec["device_ms"],
        "kmer_bins_plus_bsearch_lookup_device_ms": pair_ms,
        "max_memory_allocated_gb": peak / 1e9,
        "allocated_before_load_gb": held / 1e9,
        "launches": launches,
        "equal_to_reference": True,
    })
    del c, db, planes, plane, canon, bins, out_k, out_p, codes_u, keys_rows
    torch.cuda.empty_cache()
    return {"kmer_bins": bins_rec, "bsearch_lookup": look_rec, "bsearch_words": words_rec}, launches


def fused_span(c, reads: str, reps: int, seed: int) -> dict:
    """fused_probe against its plain version on the first span of `reads`:
    the span's hashes (kmer_front_words) and search mask on the loaded fused
    plane, with the rows that answer (fused_rows), the bound those rows give
    and both random-sector floors (fused_floors)."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words
    from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain

    db = c.dbs[0]
    fused, lb = db.hash_table[0], db.hash_lb
    _, buf, offs, _, _ = next(c._iter_native_spans(reads))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    cw = torch.from_numpy(codes_w.view(np.int32)).cuda()
    aw = torch.from_numpy(ambig_w.view(np.int32)).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    hashes, _, kmer_ambig = kmer_front_words(cw, aw, c.k, c._cfg.hll_p)
    w = hashes.shape[1]
    search = (torch.arange(w, device="cuda")[None, :] < (lengths - (c.k - 1)).clamp(min=0)[:, None]) & ~kmer_ambig
    rows = fused_rows(fused, hashes, search, lb)
    return check_kernel(
        "fused_probe span", tuple(hashes.shape),
        lambda: (hash_lookup_kmers((fused,), hashes, search),),
        lambda: (hash_lookup_plain((fused,), hashes, search),),
        reps=reps, bound=fused_bound(search, rows, fused.numel() * 4),
        extra={"lb": lb, "table_gb": fused.numel() * 4 / 1e9, **fused_floors(fused, search, rows, seed)},
    )


def phase_fused(ref, reps: int):
    """10. The fused fallback: the built database of phase 14 (`ref`, its
    run of phase 4's reads) loaded with CHD placement made to fail at every
    width (its table caches removed first, so the load builds the fused
    two-choice layout over value-pool ids), the caches removed again after
    the load (no later phase reads a fused table); phase 4's reads through
    Classifier.run and write_report, byte-equal to `ref`'s run (its kraken
    output is phase 4's), with fused_probe launched once per span and
    chd_probe never; one span step against the plain one; fused_probe on
    that span's hashes and the real plane (fused_span)."""
    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    db_dir = os.path.dirname(ref["kraken"])
    remove_port_caches(db_dir)
    held = torch.cuda.memory_allocated()
    t = time.time()
    with forced_fallback("fused"):
        c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda"))
    load_s = time.time() - t
    remove_port_caches(db_dir)
    db = c.dbs[0]
    if (c._cfg.lookup_mode != "hash" or db.hash_table is None or len(db.hash_table) != 1 or c._pool is None
            or c.route != "span"):
        raise AssertionError("the forced fallback should probe the fused layout over pool ids on the span route")
    table_gb = db.hash_table[0].numel() * 4 / 1e9
    log(f"fused fallback loaded in {load_s:.1f}s {db.timings}; lb={db.hash_lb}, {table_gb:.3f} GB plane")
    out_path, report_path = os.path.join(db_dir, "kraken_fused.out"), os.path.join(db_dir, "report_fused.tsv")
    run_s, classify_s, launches, peak = timed_run(c, ref["reads"], out_path, report_path)
    log(f"fused: {c.total_sequences} reads in {run_s:.1f}s, {c.n_spans} spans, launches {launches}")
    per_span = ("fused_probe", "kmer_front", "scores", "pack_runs")
    off_path = ("chd_probe", "bsearch_words", "bsearch_lookup", "kmer_bins")
    if c.n_units or any(launches[k] != c.n_spans for k in per_span) or any(launches[k] for k in off_path):
        raise AssertionError(f"fused: {c.n_units} Python-route units, launches {launches} for {c.n_spans} spans")
    same_bytes(((out_path, ref["kraken"]), (report_path, ref["report"])))
    log("fused kraken output and report: byte-equal to the reference run's")

    _, buf, offs, _, _ = next(c._iter_native_spans(ref["reads"]))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    out_k = c._span_step(codes_w, ambig_w, lengths_np)
    out_p = c._span_step(codes_w, ambig_w, lengths_np, plain=True)
    torch.cuda.synchronize()
    for key in out_p:
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"fused span: kernel step differs from plain step in {key!r}")
    by_op = device_ms_by_op(lambda: c._span_step(codes_w, ambig_w, lengths_np), reps=5)
    rec = fused_span(c, ref["reads"], reps, 97)
    spans = max(c.n_spans, 1)
    emit({
        "phase": "fused",
        "route": c.route,
        "db_keys": int(db.key_ct),
        "lb": db.hash_lb,
        "table_gb": table_gb,
        "load_s": load_s,
        "placement_s": db.timings.get("build_place"),
        "load_steps_s": db.timings,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_reference": ref["reads_per_s"],
        "classify_s": classify_s,
        "spans": c.n_spans,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k_: v / spans for k_, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "span_step_device_ms_by_op": by_op,
        "fused_probe_span": {key: rec.get(key) for key in (
            "device_ms", "floor_ms", "floor_1row_ms", "floor_mix_ms", "rows_answered", "row1_share", "bound_ms")},
        "max_memory_allocated_gb": peak / 1e9,
        "allocated_before_load_gb": held / 1e9,
        "launches": launches,
        "equal_to_reference": True,
    })
    del c, db, out_k, out_p
    torch.cuda.empty_cache()
    return rec, launches


def phase_fallback_compare(reps: int) -> None:
    """--fallback-only DIR: phase 4's database and reads (built, or reused
    from an earlier run of the same call, under this checkout's _build/),
    loaded by DIR's package under both forced fallbacks, each from a
    directory of its own that links the database's files: the binary search
    (no table cache: the build fails), then the fused layout (its table
    cache kept there, so every load after a call's first is warm; the
    packages' cache keys agree while their build sources do). On the first
    span: the bins and the search, as bsearch_words (a package that has
    it) and as the pair kmer_bins + bsearch_lookup, each against its plain
    version; fused_probe as phase 10 times it (fused_span); one JSON line."""
    import torch

    import krakenuniq_tpu_torch
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.classify import device_step as ds
    from krakenuniq_tpu_torch.lookup.xla_lookup import lookup_kmers, lookup_kmers_plain

    db_dir, genomes, _ = ensure_db_dir(N_SPECIES, GENOME_LEN, 31, 12, PAD_NODES, BALLAST)
    reads = ensure_reads(db_dir, genomes)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(krakenuniq_tpu_torch.__file__)))
    dirs = {}
    for kind in ("bsearch", "fused"):
        dirs[kind] = f"{db_dir}_{kind}"
        os.makedirs(dirs[kind], exist_ok=True)
        for name in ("database.kdb", "database.idx", "taxDB"):
            if not os.path.lexists(os.path.join(dirs[kind], name)):
                os.symlink(os.path.join(db_dir, name), os.path.join(dirs[kind], name))
    line = {"phase": "fallback_compare", "package": pkg}

    remove_port_caches(dirs["bsearch"])
    t = time.time()
    with forced_fallback("bsearch"):
        c = Classifier([dirs["bsearch"]], ClassifyOptions(print_progress=False, device="cuda"))
    line["bsearch_load_s"] = time.time() - t
    if c._cfg.lookup_mode != "bsearch":
        raise AssertionError(f"fallback compare: the bsearch load took lookup mode {c._cfg.lookup_mode}")
    db = c.dbs[0]
    planes, n_iter, k, nt = db.sorted_planes, c._cfg.n_iter, c.k, c.nt
    _, buf, offs, _, _ = next(c._iter_native_spans(reads))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    cw = torch.from_numpy(codes_w.view(np.int32)).cuda()
    aw = torch.from_numpy(ambig_w.view(np.int32)).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    b, lb = cw.shape[0], 16 * cw.shape[1]
    if hasattr(ds, "bsearch_words"):
        plane = (*planes, db.bin_start)
        line["bsearch_words"] = check_kernel(
            "bsearch_words", (b, lb - k + 1),
            lambda: ds.bsearch_words(plane, cw, aw, lengths, k, nt, n_iter),
            lambda: ds.bsearch_words_plain(plane, cw, aw, lengths, k, nt, n_iter),
            reps=reps, bound=words_bound(cw, aw, lengths, k, nt, plane, n_iter, None), extra={"n_iter": n_iter},
        )
    codes_u = ds._unpack_codes(cw)
    bins_rec = check_kernel(
        "kmer_bins words", (b, lb), lambda: ds.kmer_bins_words(cw, k, nt), lambda: ds.kmer_bins_plain(codes_u, k, nt),
        reps=reps, bound=bins_bound(b, lb, k, nt, True),
    )
    canon, bins = ds.kmer_bins_words(cw, k, nt)
    _, _, kmer_ambig = ds.kmer_front_words(cw, aw, k, c._cfg.hll_p)
    w = lb - k + 1
    search = (torch.arange(w, device="cuda")[None, :] < (lengths - (k - 1)).clamp(min=0)[:, None]) & ~kmer_ambig
    look_rec = check_kernel(
        "bsearch_lookup", (b, w),
        lambda: lookup_kmers(*planes, canon, bins, search, n_iter, db.bin_start),
        lambda: lookup_kmers_plain(*planes, canon, bins, search, n_iter, db.bin_start),
        reps=reps, bound=bsearch_bound(planes, canon, bins, search, n_iter, db.bin_start), extra={"n_iter": n_iter},
    )
    line.update({"kmer_bins": bins_rec, "bsearch_lookup": look_rec,
                 "kmer_bins_plus_bsearch_lookup_device_ms": bins_rec["device_ms"] + look_rec["device_ms"]})
    del c, db, planes, canon, bins
    torch.cuda.empty_cache()

    t = time.time()
    with forced_fallback("fused"):
        c = Classifier([dirs["fused"]], ClassifyOptions(print_progress=False, device="cuda"))
    line["fused_load_s"], line["fused_load_steps_s"] = time.time() - t, c.dbs[0].timings
    if c.dbs[0].hash_table is None or len(c.dbs[0].hash_table) != 1:
        raise AssertionError("fallback compare: the fused load did not build the fused layout")
    line["fused_probe"] = fused_span(c, reads, reps, 97)
    emit(line)
    del c
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8


def head_reads(path: str, n: int) -> str:
    """The first n two-line FASTA records of `path`, in a file beside it."""
    sub = os.path.join(os.path.dirname(path), f"reads_{n}.fa")
    if not os.path.exists(sub):
        with open(path) as f, open(sub + ".tmp", "w") as g:
            for i, line in enumerate(f):
                if i >= 2 * n:
                    break
                g.write(line)
        os.replace(sub + ".tmp", sub)
    return sub


def ooc_group_pass(c, feeds, prefetch: bool) -> dict:
    """One pass of every chunk table for a group of spans (their feeds on
    the card), double- or single-buffered: the copies' and the probes'
    summed ms, each chunk pass's ms, the group's first-to-last ms on the
    step stream, and the share of the copy time that did not lengthen the
    group."""
    import torch

    c._ooc_prefetch = prefetch
    torch.cuda.synchronize()
    before = {kind: len(ms) for kind, ms in c.ooc_timings().items()}
    c._ooc_probe_group([{"feed": f, "acc": None} for f in feeds])
    new = {kind: ms[before[kind]:] for kind, ms in c.ooc_timings().items()}
    up, probe, group = sum(new["upload"]), sum(new["probe"]), new["group"][0]
    return {"double_buffered": prefetch, "copies": len(new["upload"]), "upload_ms": up,
            "upload_ms_by_copy": new["upload"], "probe_ms": probe, "probe_ms_by_pass": new["probe"], "group_ms": group,
            "hidden_share": 1 - max(group - probe, 0.0) / up if up else None}


def span_lanes(feed, k: int, nt: int):
    """(in_read, searched, bins) of a packed feed on the card: the lanes in
    their read, those of them free of ambiguous bases, and every lane's
    minimizer bin (nt-mers) (the kmer_front and kmer_bins kernels)."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_bins_words, kmer_front_words

    codes, ambig, lengths = feed
    _, _, kmer_ambig = kmer_front_words(codes, ambig, k, 12)  # the encodings go unused
    _, bins = kmer_bins_words(codes, k, nt)
    w = bins.shape[1]
    in_read = torch.arange(w, device=codes.device)[None, :] < (lengths - (k - 1)).clamp(min=0)[:, None]
    return in_read, in_read & ~kmer_ambig, bins


def acc_pass(feed, planes, bounds, k: int, nt: int):
    """The pass of a chunk table (`planes` on the card, its bin range
    `bounds`) on a span's packed feed, as a function of the word plane,
    updated in place (plain=True: the plain version)."""
    from krakenuniq_tpu_torch.classify.device_step import probe_chunk_core

    return lambda acc, plain=False: probe_chunk_core(acc, planes, bounds, *feed, k, nt, plain=plain)


def check_routing(feed, planes, bounds, k: int, nt: int, acc0, want) -> None:
    """chd_probe_acc routes by bin on the card: the chunk table `planes`
    (bin range `bounds`) probed from the word plane acc0 under an empty
    range and under the range of the same width beside it sets no lane (the
    table's keys all have their bins in `bounds`, so only a lane the kernel
    failed to skip could hit), and under the whole bin space sets exactly
    `want`, the routed pass's result. Raises when `want` sets no lane."""
    import torch

    if torch.equal(want, acc0):
        raise AssertionError("chd_probe_acc routing check: the routed pass sets no lane")
    lo, hi = (int(x) for x in bounds)
    top = 4 ** nt
    away = (hi, min(top, 2 * hi - lo)) if hi < top else (0, lo)
    for rng in ((0, 0), away):
        got = acc_pass(feed, planes, rng, k, nt)(acc0.clone())
        if not torch.equal(got, acc0):
            raise AssertionError(f"chd_probe_acc under bins {rng}, outside the table's {bounds}, set "
                                 f"{int((got != acc0).sum())} lanes")
    got = acc_pass(feed, planes, (0, top), k, nt)(acc0.clone())
    if not torch.equal(got, want):
        raise AssertionError("chd_probe_acc under the whole bin space differs from the routed pass")


def group_acc_bound(c, cdb, feeds) -> dict:
    """The least card time of one group's chunk passes of cdb: each pass
    reads the acc word of every lane in its read (4 B); the packed code and
    flag words (3 bits a base) and the bin work (13 operations an nt-mer
    position, 6 a lane) of every row with a lane in its read are needed
    once; a searched lane is probed exactly once, in the pass of the chunk
    that owns its bin (no other pass can set it first), ~33 operations, and
    its word is written (4 B) where it hit (the hits of one group pass).
    Of each chunk's planes a 32 B sector per lane routed to it, but no more
    than the plane (each input read once). Also returns each chunk's routed
    lanes over the group, derived from the bins (the kmer_bins kernel), and
    the random-sector bytes before the cap. Raises unless the chunk ranges
    route every searched lane to one chunk."""
    spans = [{"feed": f, "acc": None} for f in feeds]
    c._ooc_probe_group(spans)
    in_read = searched = rows = hits = 0
    routed = [0] * cdb.n_chunks
    lb = 16 * feeds[0][0].shape[1]
    for feed, st in zip(feeds, spans):
        r, sr, bins = span_lanes(feed, c.k, cdb.nt)
        in_read += int(r.sum())
        searched += int(sr.sum())
        rows += int(r.any(dim=1).sum())
        hits += int((st["acc"] != 0).sum())
        for ci, (lo, hi) in enumerate(cdb.bounds):
            routed[ci] += int((sr & (bins >= lo) & (bins < hi)).sum())
    if sum(routed) != searched:
        raise AssertionError(f"the chunk ranges {cdb.bounds} route {sum(routed)} of {searched} searched lanes")
    table = uncapped = 0
    for ci, n in enumerate(routed):
        for p in cdb.chunk_planes[ci]:
            table += min(p.numel() * p.element_size(), 32 * n)
            uncapped += 32 * n
    moved = cdb.n_chunks * 4 * in_read + rows * (lb * 3 // 8 + 4) + table + 4 * hits
    out = bound(moved, rows * (13 * (lb - cdb.nt + 1) + 6 * (lb - c.k + 1)) + 33 * searched)
    return {**out, "table_bytes": table, "table_bytes_uncapped": uncapped, "lanes_searched": searched,
            "lanes_routed_by_chunk": routed, "hits": hits}


def record_chunk_check(c, cdb, first, reps: int) -> tuple[dict, dict]:
    """The out-of-core pass (chd_probe_acc, or rows_probe_acc over raw
    chunk tables) against its plain version on the chunk table of cdb that
    holds most of the span feed `first`'s hits, with a seeded half of the
    span's merged words set, beside floor_ms (row_gather over as many random
    16 B rows of its last plane as it probes lanes; over raw chunks the
    split of the probed lanes, rows_split, sets the bound's sectors); then
    its routing on the card (check_routing). Hits do not spread evenly over
    the chunks: a k-mer's bin is its least scrambled nt-mer, so the genomes'
    k-mers crowd into low bins, while the ballast keys that fill the chunks
    are spread uniformly over the bins. Returns (the check's record, {the
    chunk, its planes on the card, the words before the pass, the span's
    hits by chunk, its searched lanes})."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words
    from krakenuniq_tpu_torch.lookup.hash_lookup import table_layout

    in_read, searched, bins = span_lanes(first, c.k, cdb.nt)
    merged = torch.zeros(bins.shape, dtype=torch.int32, device="cuda")
    hits_by_chunk = []
    for ci in range(cdb.n_chunks):
        before = int((merged != 0).sum())
        acc_pass(first, tuple(p.cuda() for p in cdb.chunk_planes[ci]), cdb.bounds[ci], c.k, cdb.nt)(merged)
        hits_by_chunk.append(int((merged != 0).sum()) - before)
    best = max(range(cdb.n_chunks), key=hits_by_chunk.__getitem__)
    keep = torch.rand(bins.shape, generator=torch.Generator(device="cuda").manual_seed(11), device="cuda") < 0.5
    acc0 = torch.where(keep, merged, 0)
    planes = tuple(p.cuda() for p in cdb.chunk_planes[best])
    lo, hi = cdb.bounds[best]
    probed = searched & (acc0 == 0) & (bins >= lo) & (bins < hi)
    raw = table_layout(planes) == "raw"
    split = rows_split(planes, kmer_front_words(first[0], first[1], c.k, 12)[0][probed],
                       torch.ones(int(probed.sum()), dtype=torch.bool, device="cuda")) if raw else None
    run = acc_pass(first, planes, cdb.bounds[best], c.k, cdb.nt)
    acc_k, acc_p = torch.empty_like(acc0), torch.empty_like(acc0)
    hits = run(acc_p.copy_(acc0), plain=True) != acc0
    rec = check_kernel(
        "rows_probe_acc" if raw else "chd_probe_acc", tuple(acc0.shape),
        lambda: (run(acc_k.copy_(acc0)),),
        lambda: (run(acc_p.copy_(acc0), plain=True),),
        reps=reps, bound=probe_acc_bound(first[0], c.k, cdb.nt, in_read, in_read & (acc0 == 0), probed, hits,
                                         planes, sectors=rows_sectors(split) if raw else None),
        extra={"restore_ms": time_ms(lambda: acc_k.copy_(acc0), reps), "lanes_set": int((acc0 != 0).sum()),
               "lanes_probed": int(probed.sum()), "lanes_unset_searched": int((searched & (acc0 == 0)).sum()),
               "chunk": best, **({"split": split} if raw else {}),
               **probe_floor(planes[1].view(-1, 4), int(probed.sum()), 59)},
    )
    check_routing(first, planes, cdb.bounds[best], c.k, cdb.nt, acc0, run(acc_k.copy_(acc0)))
    return rec, {"chunk": best, "planes": planes, "acc0": acc0, "hits_by_chunk": hits_by_chunk,
                 "lanes_searched": int(searched.sum())}


def ooc_passes(c, feeds, reps: int) -> tuple[dict, dict]:
    """The chunk passes of an out-of-core Classifier over a group of span
    feeds: the group double- and single-buffered in turns, the first and
    the later chunk passes' ms (CUDA events on the step stream, medians over
    the turns); chd_probe_acc's card time summed over one group's chunk
    sequence (every launch, profiler), the group's card records by op and
    its bound (group_acc_bound, with the lanes routed to each chunk, derived
    from the bins); and chd_probe_acc on the first span's record chunk
    (record_chunk_check). Returns (summary, the check's record)."""
    cdb = c._ooc[0]
    n_chunks = cdb.n_chunks
    turns = [ooc_group_pass(c, feeds, pf) for pf in (True, False, False, True)]
    c._ooc_prefetch = True

    def group():
        c._ooc_probe_group([{"feed": f, "acc": None} for f in feeds])

    group_ms, group_by = device_ms(group, "chd_probe_acc", 3, per_call=len(feeds) * n_chunks)
    group_by_op = device_ms_by_op(group, reps=2)

    rec, record = record_chunk_check(c, cdb, feeds[0], reps)
    passes = [t["probe_ms_by_pass"] for t in turns]
    group_bound = group_acc_bound(c, cdb, feeds)
    summary = {
        "group_turns": turns,
        "probe_ms_first_pass": statistics.median(p[0] for p in passes),
        "probe_ms_later_passes": statistics.median(ms for p in passes for ms in p[1:]),
        "group_chd_probe_acc_device_ms": group_ms,
        "group_chd_probe_acc_device_ms_by": group_by,
        "group_device_ms_by_op": group_by_op,
        "group_bound_ms": group_bound["bound_ms"],
        "group_bound_by": group_bound["bound_by"],
        "group_table_bytes": group_bound["table_bytes"],
        "group_table_bytes_uncapped": group_bound["table_bytes_uncapped"],
        "group_lanes_searched": group_bound["lanes_searched"],
        "group_lanes_routed_by_chunk": group_bound["lanes_routed_by_chunk"],
        "group_hits": group_bound["hits"],
        "span0_hits_by_chunk": record["hits_by_chunk"],
        "span0_lanes_searched": record["lanes_searched"],
    }
    return summary, rec


def span_feeds(c, reads: str) -> list:
    """Every span of `reads`, encoded and its feed on the card."""
    feeds = []
    for kind, buf, offs, _, _ in c._iter_native_spans(reads):
        if kind != "span":
            raise AssertionError(f"a chunk of the reads took the {kind} path")
        feeds.append(c._span_feed(*c._encode_span(buf, offs)))
    return feeds


def ooc_warm_reload() -> tuple[float, dict]:
    """Out of core, cold then warm, on a copy of the golden database under
    _build/ooc_warm/ at 64 KiB (5 chunk tables of its ~139 KB): the cold load writes
    `.htc_torch`, the warm one takes the chunk tables from it (no build, the
    same bounds, the planes bit-equal), and both classify reads.fa as
    kraken.out has it. Returns (warm load s, its steps)."""
    import shutil

    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    root = os.path.join(ROOT, "krakenuniq_tpu_torch", "_build", "ooc_warm")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for f in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
        shutil.copy(os.path.join(GOLDEN, f), os.path.join(root, f))
    opts = ClassifyOptions(print_progress=False, device="cuda", preload_size=64 << 10)
    with open(os.path.join(GOLDEN, "kraken.out")) as f:
        want = f.read()
    loads = []
    for _ in range(2):
        t = time.time()
        c = Classifier([root], opts)
        loads.append((time.time() - t, c))
        out = io.StringIO()
        c.run([os.path.join(GOLDEN, "reads.fa")], kraken_fh=out)
        if out.getvalue() != want or c._ooc is None or c._ooc[0].n_chunks < 2:
            raise AssertionError("out of core on the golden copy: kraken output differs or not out of core")
    (_, cold), (warm_s, warm) = loads
    cdb, wdb = cold._ooc[0], warm._ooc[0]
    if cdb.timings.get("cache") != "miss" or wdb.timings.get("cache") != "hit" or "build" in wdb.timings or \
            wdb.bounds != cdb.bounds or not all(torch.equal(a, b) for pa, pb in zip(wdb.chunk_planes, cdb.chunk_planes)
                                                for a, b in zip(pa, pb)):
        raise AssertionError(f"the warm chunk load did not take the cached tables as built: {wdb.timings}")
    log(f"out of core on the golden copy, warm reload in {warm_s:.2f}s {wdb.timings}: {wdb.n_chunks} cached "
        f"chunk tables, bit-equal")
    return warm_s, wdb.timings


def phase_ooc(ref, reps: int):
    """Out of core (--preload-size PRELOAD_SIZE_BUILT) on the built database
    of phase 14 (`ref`, its run of phase 4's reads): the chunk tables
    streamed through the card, byte-equal to that run (its kraken output is
    phase 4's) with and without device counters, double- and single-buffered;
    the chunk passes measured (ooc_passes) and chd_probe_acc against its
    plain version on one real chunk."""
    import statistics as st_

    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    db_dir = os.path.dirname(ref["kraken"])
    chunk_cache = os.path.join(db_dir, "database.kdb.htc_torch")
    if os.path.exists(chunk_cache):  # a cold chunk build
        os.unlink(chunk_cache)
    t = time.time()
    c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda", preload_size=PRELOAD_SIZE_BUILT))
    load_s = time.time() - t
    if c._ooc is None or c.route != "span":
        raise AssertionError(f"preload_size = {PRELOAD_SIZE_BUILT} B should stream the built database on the span route")
    cdb = c._ooc[0]
    n_chunks, chunk_bytes = cdb.n_chunks, cdb.chunk_bytes()
    log(f"out of core: {n_chunks} chunks of {chunk_bytes / 1e6:.1f} MB at lr={cdb.lb}, loaded in {load_s:.1f}s "
        f"{cdb.timings}")
    if n_chunks < 4 or 2 * chunk_bytes > PRELOAD_SIZE_BUILT or not c._ooc_prefetch:
        raise AssertionError(f"out-of-core plan: {n_chunks} chunks of {chunk_bytes} B, "
                             f"double-buffered {c._ooc_prefetch}, budget {PRELOAD_SIZE_BUILT}")
    if cdb.timings.get("cache") != "miss" or not os.path.exists(chunk_cache):
        raise AssertionError(f"the cold chunk build wrote no cache: {cdb.timings}")

    # run 1: the default options, one group of every span. The chunk passes
    # compute their own k-mer front, so kmer_front runs once a span (the
    # finish step)
    out_path, report_path = os.path.join(db_dir, "kraken_ooc.out"), os.path.join(db_dir, "report_ooc.tsv")
    run_s, classify_s, launches, peak = timed_run(c, ref["reads"], out_path, report_path)
    spans = c.n_spans
    log(f"out of core: {c.total_sequences} reads in {run_s:.1f}s, {spans} spans, {c.ooc_groups} groups, "
        f"launches {launches}")
    want = {"chd_probe_acc": spans * n_chunks, "kmer_front": spans, "chd_probe": 0,
            "scores": spans, "pack_runs": spans}
    if c.n_units or spans == 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"out of core: {c.n_units} Python-route units, launches {launches}, want {want}")
    same_bytes(((out_path, ref["kraken"]), (report_path, ref["report"])))
    log("out-of-core kraken output and report: byte-equal to the reference run's")
    times = c.ooc_timings()
    probe = times["probe"]
    run1 = {"reads": c.total_sequences, "run_s": run_s, "classify_s": classify_s, "spans": spans,
            "groups": c.ooc_groups, "host_s_per_span": c.host_seconds / spans,
            "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
            "device_s_per_span": c.device_seconds / spans,
            "run_probe_ms_first_pass": st_.median(probe[::n_chunks]),
            "run_probe_ms_later_passes": st_.median(ms for i, ms in enumerate(probe) if i % n_chunks)}

    # run 2: device counters in groups of 256 MiB
    cd = Classifier.with_shared_db(c, device_counters=True, ooc_group_bytes=OOC_GROUP_BYTES)
    paths = (os.path.join(db_dir, "kraken_ooc_dc.out"), os.path.join(db_dir, "report_ooc_dc.tsv"))
    r2_s, _, r2_launches, _ = timed_run(cd, ref["reads"], *paths)
    if cd.ooc_groups < 2 or r2_launches["chd_probe_acc"] != cd.n_spans * n_chunks or r2_launches["chd_probe"]:
        raise AssertionError(f"out of core, device counters: {cd.ooc_groups} groups, launches {r2_launches}")
    same_bytes(zip(paths, (ref["kraken"], ref["report"])))
    run2 = {"run_s": r2_s, "reads_per_s": cd.total_sequences / r2_s, "groups": cd.ooc_groups, "spans": cd.n_spans}
    log(f"out of core, device counters: {cd.ooc_groups} groups in {r2_s:.1f}s, byte-equal to the reference run's")
    del cd

    # run 3: single-buffered on the first reads
    sub = head_reads(ref["reads"], N_READS_SINGLE)
    cs = Classifier.with_shared_db(c, ooc_double_buffer=False)
    if cs._ooc_prefetch:
        raise AssertionError("ooc_double_buffer=False still prefetches")
    paths = (os.path.join(db_dir, "kraken_ooc_single.out"), os.path.join(db_dir, "report_ooc_single.tsv"))
    r3_s, _, _, _ = timed_run(cs, sub, *paths)
    with open(ref["kraken"], "rb") as f:
        want_lines = b"".join(line for _, line in zip(range(N_READS_SINGLE), f))
    with open(paths[0], "rb") as f:
        if f.read() != want_lines:
            raise AssertionError("single-buffered out-of-core output differs from the reference run's lines for "
                                 "its reads")
    run3 = {"reads": cs.total_sequences, "run_s": r3_s, "reads_per_s": cs.total_sequences / r3_s}
    log(f"out of core, single-buffered: {cs.total_sequences} reads in {r3_s:.1f}s, byte-equal to the reference "
        f"run's lines")
    del cs

    # the run's spans as one group: the passes measured, the kernel checked
    feeds = span_feeds(c, ref["reads"])
    passes, rec = ooc_passes(c, feeds, reps)
    del feeds

    # N_LONG_OOC of phase 11's long reads out of core: its lines for them
    long_run = {}
    if "long_ooc" in ref:
        long_path, want_long = ref["long_ooc"]
        cl = Classifier.with_shared_db(c)
        lp = (os.path.join(db_dir, "kraken_ooc_long.out"), os.path.join(db_dir, "report_ooc_long.tsv"))
        rl_s, _, rl_launches, _ = timed_run(cl, long_path, *lp)
        with open(lp[0], "rb") as f:
            if f.read() != want_long or cl.n_long_reads != N_LONG_OOC:
                raise AssertionError("out-of-core long reads differ from phase 11's lines for them")
        long_run = {"reads": cl.n_long_reads, "run_s": rl_s, "launches": rl_launches}
        log(f"out of core, {cl.n_long_reads} long reads in {rl_s:.1f}s: byte-equal to phase 11's lines")
        del cl

    # a warm reload from the port's chunk cache, on a copy of the golden
    # database (a warm reload of this one took ~41 s)
    warm_s, warm_steps = ooc_warm_reload()

    upload = times["upload"]
    emit({
        "phase": "ooc",
        "budget": PRELOAD_SIZE_BUILT,
        "chunks": n_chunks,
        "chunk_bytes": chunk_bytes,
        "lr": cdb.lb,
        "bounds": cdb.bounds,
        "double_buffered": True,
        "groups": c.ooc_groups,
        "load_s": load_s,
        "load_steps_s": cdb.timings,
        "warm_reload_golden_copy_s": warm_s,
        "warm_reload_golden_copy_steps_s": warm_steps,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_reference": ref["reads_per_s"],
        **run1,
        "upload_ms_per_chunk": st_.median(upload) if upload else None,
        "upload_gb_per_s": chunk_bytes / st_.median(upload) / 1e6 if upload else None,
        "probe_ms_per_chunk_pass": st_.median(probe) if probe else None,
        "probe_ms_by_chunk": probe,
        "group_ms": times["group"],
        **passes,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "equal_to_reference": True,
        "device_counters_run": run2,
        "single_buffered_run": run3,
        "long_reads_run": long_run,
    })
    del c
    torch.cuda.empty_cache()
    return rec, launches


def phase_ooc_compare(reps: int) -> None:
    """--ooc-only DIR: phase 4's database and reads (built, or reused from
    an earlier run of the same call, under this checkout's _build/), loaded
    out of core at PRELOAD_SIZE by DIR's package, from a directory of its
    own that links the database's files (the chunk cache's key holds a
    digest of the package's chunk code, so each package keeps its own
    cache and loads warm after its first run), and the chunk passes measured
    by ooc_passes; one JSON line."""
    import hashlib

    import krakenuniq_tpu_torch
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    db_dir, genomes, _ = ensure_db_dir(N_SPECIES, GENOME_LEN, 31, 12, PAD_NODES, BALLAST)
    reads = ensure_reads(db_dir, genomes)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(krakenuniq_tpu_torch.__file__)))
    own = f"{db_dir}_ooc_{hashlib.sha256(pkg.encode()).hexdigest()[:12]}"
    os.makedirs(own, exist_ok=True)
    for name in ("database.kdb", "database.idx", "taxDB"):
        if not os.path.lexists(os.path.join(own, name)):
            os.symlink(os.path.join(db_dir, name), os.path.join(own, name))
    t = time.time()
    c = Classifier([own], ClassifyOptions(print_progress=False, device="cuda", preload_size=PRELOAD_SIZE))
    load_s = time.time() - t
    cdb = c._ooc[0]
    log(f"out of core ({pkg}): {cdb.n_chunks} chunks, loaded in {load_s:.1f}s {cdb.timings}")
    passes, rec = ooc_passes(c, span_feeds(c, reads), reps)
    emit({"phase": "ooc_compare", "package": pkg, "chunks": cdb.n_chunks, "bounds": cdb.bounds,
          "load_s": load_s, "load_steps_s": cdb.timings, **passes, "chd_probe_acc": rec})


def launch_ms(fn, symbols, n: int) -> tuple[list | None, str]:
    """Each of the n launches of the kernels named by `symbols` in one call
    of fn(), in launch order: their card milliseconds under torch.profiler
    (device_ms's idle margins); None where every session lost a record.
    Returns (the list, "profiler" or "lost")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        evs = sorted((e for e in prof.events()
                      if e.device_type.name == "CUDA" and any(sym in e.name for sym in symbols)),
                     key=lambda e: e.time_range.start)
        if len(evs) == n:
            return [e.device_time_total / 1e3 for e in evs], "profiler"
        log(f"profiler saw {len(evs)} of {n} launches of {symbols}, margin {margin} s")
    return None, "lost"


def uid_ooc_passes(c, feeds, reps: int) -> tuple[dict, dict]:
    """The chunk passes of an out-of-core UID Classifier (raw chunk tables)
    over a group of span feeds: the group double- and single-buffered in
    turns (ooc_group_pass: each copy's and each chunk pass's ms, CUDA events
    on the copy and step streams); rows_probe_acc's card ms of each launch
    of one group (launch_ms), summed per chunk; and, from a replay of the
    group's passes in its order (chunk by chunk, each span's word plane
    carried over), each chunk's lanes routed (searched lanes whose bin the
    chunk owns), probed (routed and still 0), screened and split
    (rows_split), the lanes it set and its bound (the sum over its launches
    of probe_acc_bound with rows_sectors). Then rows_probe_acc on the first
    span's record chunk (record_chunk_check). Returns (summary, the check's
    record)."""
    import torch

    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words

    cdb = c._ooc[0]
    n_chunks, n_spans = cdb.n_chunks, len(feeds)
    turns = [ooc_group_pass(c, feeds, pf) for pf in (True, False, False, True)]
    c._ooc_prefetch = True
    per_launch, by = launch_ms(lambda: c._ooc_probe_group([{"feed": f, "acc": None} for f in feeds]),
                               SYMBOLS["rows_probe_acc"], n_chunks * n_spans)
    lanes = [(*span_lanes(f, c.k, cdb.nt), kmer_front_words(f[0], f[1], c.k, 12)[0]) for f in feeds]
    accs = [torch.zeros(ln[2].shape, dtype=torch.int32, device="cuda") for ln in lanes]
    chunks = []
    for ci in range(n_chunks):
        planes = tuple(p.cuda() for p in cdb.chunk_planes[ci])
        lo, hi = (int(x) for x in cdb.bounds[ci])
        row = {"chunk": ci, "bins": [lo, hi], "lanes_routed": 0, "lanes_probed": 0, "lanes_set": 0,
               "split": {"b1": 0, "b2": 0, "none": 0, "b2_reads": 0}, "bound_ms": 0.0}
        for si, (feed, (in_read, searched, bins, hashes)) in enumerate(zip(feeds, lanes)):
            before = accs[si].clone()
            routed = searched & (bins >= lo) & (bins < hi)
            probed = routed & (before == 0)
            split = rows_split(planes, hashes[probed], torch.ones(int(probed.sum()), dtype=torch.bool,
                                                                   device="cuda"))
            hits = acc_pass(feed, planes, (lo, hi), c.k, cdb.nt)(accs[si]) != before
            row["bound_ms"] += probe_acc_bound(feed[0], c.k, cdb.nt, in_read, in_read & (before == 0), probed,
                                               hits, planes, sectors=rows_sectors(split))["bound_ms"]
            row["lanes_routed"] += int(routed.sum())
            row["lanes_probed"] += int(probed.sum())
            row["lanes_set"] += int(hits.sum())
            for key in row["split"]:
                row["split"][key] += split[key]
        row["device_ms"] = None if per_launch is None else sum(per_launch[ci * n_spans:(ci + 1) * n_spans])
        copies = [t["upload_ms_by_copy"][ci] for t in turns if t["copies"] == n_chunks]
        row["copy_ms"] = statistics.median(copies) if copies else None
        row["pass_ms"] = statistics.median(t["probe_ms_by_pass"][ci] for t in turns)
        chunks.append(row)
        del planes

    rec, record = record_chunk_check(c, cdb, feeds[0], reps)
    passes = [t["probe_ms_by_pass"] for t in turns]
    summary = {
        "group_turns": turns,
        "probe_ms_first_pass": statistics.median(p[0] for p in passes),
        "probe_ms_later_passes": statistics.median(ms for p in passes for ms in p[1:]),
        "group_rows_probe_acc_device_ms": None if per_launch is None else sum(per_launch),
        "group_rows_probe_acc_device_ms_by": by,
        "group_bound_ms": sum(r["bound_ms"] for r in chunks),
        "chunk_passes": chunks,
        "span0_hits_by_chunk": record.pop("hits_by_chunk"),
        "record_chunk": record,
    }
    return summary, rec


def phase_uid_ooc_compare(reps: int) -> None:
    """--uid-ooc-only DIR: phase 4's database and reads with phase 13's UID
    values (ensure_db_dir, ensure_reads, ensure_uid_db: built, or reused from
    an earlier run of the same call, under this checkout's _build/), loaded
    by DIR's package from one directory that links the database's files,
    whose table caches are kept there (every load after a call's first is
    warm while the packages' build sources agree). Resident: rows_probe on
    the first span of phase 13's reads (the first N_READS_UID) and the real
    planes (rows_case). Out of core at PRELOAD_SIZE (raw chunk tables): the
    spans of those reads probed as one group (uid_ooc_passes). On a package
    whose tools/kernel_variants has the raw probe's designs, those designs on
    the same span and on the record chunk. One JSON line."""
    import gc

    import torch

    import krakenuniq_tpu_torch
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words

    db_dir, genomes, _ = ensure_db_dir(N_SPECIES, GENOME_LEN, 31, 12, PAD_NODES, BALLAST)
    reads = head_reads(ensure_reads(db_dir, genomes), N_READS_UID)
    uid_write_s = ensure_uid_db(db_dir, genomes)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(krakenuniq_tpu_torch.__file__)))
    own = f"{db_dir}_uid"
    os.makedirs(own, exist_ok=True)
    for name in ("database.kdb", "database.idx", "taxDB", "uid_database.kdb", "uid_to_taxid.map"):
        if not os.path.lexists(os.path.join(own, name)):
            os.symlink(os.path.join(db_dir, name), os.path.join(own, name))
    try:
        from krakenuniq_tpu_torch.tools import kernel_variants as kv
    except ImportError:
        kv = None
    kv = kv if hasattr(kv, "run_rows") else None
    fns = kv.build(["rows_probe"]) if kv else None
    line = {"phase": "uid_ooc_compare", "package": pkg, "uid_db_write_s": uid_write_s}

    t = time.time()
    c = Classifier([own], ClassifyOptions(print_progress=False, device="cuda"), uid_database=True)
    line["resident_load_s"] = time.time() - t
    line["resident_cache"] = c.dbs[0].timings.get("cache")
    _, buf, offs, _, _ = next(c._iter_native_spans(reads))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    cw, aw = (torch.from_numpy(a.view(np.int32)).cuda() for a in (codes_w, ambig_w))
    hashes, _, kmer_ambig = kmer_front_words(cw, aw, c.k, c._cfg.hll_p)
    lengths = torch.from_numpy(lengths_np).cuda()
    search = (torch.arange(hashes.shape[1], device="cuda")[None, :]
              < (lengths - (c.k - 1)).clamp(min=0)[:, None]) & ~kmer_ambig
    planes = c._db_planes[0]
    _, line["rows_probe"] = rows_case("rows_probe", planes, hashes, search, reps, 103)
    if kv:
        kv.run_rows(fns["rows_probe"], reps, emit, "phase 13 span", planes, hashes, search)
    del c, planes, hashes, search
    gc.collect()
    torch.cuda.empty_cache()

    t = time.time()
    c = Classifier([own], ClassifyOptions(print_progress=False, device="cuda", preload_size=PRELOAD_SIZE),
                   uid_database=True)
    line["load_s"] = time.time() - t
    cdb = c._ooc[0]
    log(f"UID out of core ({pkg}): {cdb.n_chunks} chunks, loaded in {line['load_s']:.1f}s {cdb.timings}")
    feeds = span_feeds(c, reads)
    passes, rec = uid_ooc_passes(c, feeds, reps)
    record = passes.pop("record_chunk")
    if kv:
        kv.run_rows_acc(fns["rows_probe_acc"], reps, emit, "phase 13 record chunk", feeds[0], record["planes"],
                        cdb.bounds[record["chunk"]], record["acc0"], c.k, cdb.nt)
    emit({**line, "spans": len(feeds), "chunks": cdb.n_chunks, "bounds": cdb.bounds,
          "load_steps_s": cdb.timings, **passes, "rows_probe_acc": rec})


def phase_counters(run4, reps: int):
    """--device-counters on the Python route (use_native=False) on phase
    4's loaded database and its first N_READS_SINGLE reads (a cut from all
    of phase 4's reads that keeps the script within its time limit):
    byte-equal to phase 4's configuration on the same reads."""
    import torch

    from krakenuniq_tpu_torch.classify import Classifier
    from krakenuniq_tpu_torch.classify.device_counters import update_core
    from krakenuniq_tpu_torch.classify.sparse_exact import sparse_stats

    c = Classifier.with_shared_db(run4["c"], device_counters=True, use_native=False)
    if c.route != "python":
        raise AssertionError(f"phase 5b takes the {c.route} route")
    dc = c.dev_counters
    if dc.host_stats or dc.sparse_cap == 0 or dc.lut is not None:
        raise AssertionError("phase 5 should run the pool layout with device sparse stats")
    db_dir = os.path.dirname(run4["kraken"])
    sub = head_reads(run4["reads"], N_READS_SINGLE)
    ref_paths = (os.path.join(db_dir, "kraken_sub.out"), os.path.join(db_dir, "report_sub.tsv"))
    ref_s, _, _, _ = timed_run(Classifier.with_shared_db(run4["c"]), sub, *ref_paths)
    out_path = os.path.join(db_dir, "kraken_dc.out")
    report_path = os.path.join(db_dir, "report_dc.tsv")
    run_s, classify_s, launches, peak = timed_run(c, sub, out_path, report_path)
    log(f"device counters: {c.total_sequences} reads in {run_s:.1f}s, launches {launches}")
    units = c.n_units
    want = {"taxon_counts": units, "hll_regmax": units, "scores": units,
            "kmer_front": units, "chd_probe": units, "sparse_stats": units, "sparse_keys": units}
    if any(launches[k] != v for k, v in want.items()) or units == 0:
        raise AssertionError(f"device-counters path launches {launches}, want {want}")
    if dc.tracker.overflows:
        raise AssertionError(f"{dc.tracker.overflows} sparse-buffer overflows: host fallback taken")
    same_bytes(zip((out_path, report_path), ref_paths))
    with open(run4["kraken"], "rb") as f:
        want_lines = b"".join(line for _, line in zip(range(N_READS_SINGLE), f))
    with open(out_path, "rb") as f:
        if f.read() != want_lines:
            raise AssertionError("phase 5b's lines differ from phase 4's for its reads")
    log("device-counters kraken output and report: byte-equal to phase 4's configuration on the same reads")

    # one full unit's update: kernels vs the same update forced to plain
    unit = next(c._work_units(sub))[0]
    enc = c._encode_unit(unit)
    out = c._device_step(enc.codes, enc.ambig, enc.lengths)
    b, w = out["taxa_dense"].shape
    row_valid = torch.zeros(b, dtype=torch.bool, device="cuda")
    row_valid[: len(unit)] = True
    unit_id = torch.zeros(b, dtype=torch.int64, device="cuda")
    args = (dc.lut, out["taxa_dense"], out["enc"], out["hll_lanes"], out["call_dense"],
            row_valid, dc.p, unit_id, dc.sparse_cap)
    state = lambda: (dc.reg.clone(), dc.kmer_counts.clone(), dc.read_counts.clone())
    got = update_core(*state(), *args)
    ref = update_core(*state(), *args, plain=True)
    torch.cuda.synchronize()
    names = ("registers", "kmer_counts", "read_counts", "sparse buf", "n_pairs", "n_events")
    for name, g, r in zip(names, got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"work unit: kernel update differs from plain update in {name}")
    n_used = int(got[4]) + int(got[5])
    log(f"work unit [{b}, {w}]: kernel update == plain update ({n_used} sparse-buffer entries)")

    taxa, lanes = out["taxa_dense"], out["hll_lanes"]
    counts = counts_check([(out["call_dense"], row_valid), (taxa, lanes)], dc.n_taxa, reps, " unit pair")
    regmax = regmax_check(dc.reg, taxa, out["enc"], lanes, None, dc.p, reps)
    # the rest of the unit's update: the sparse stats (sort and kernel),
    # and the host's fetch-and-fold of the report (finalize: one state fetch)
    stats_ms = time_ms(
        lambda: sparse_stats(taxa, out["enc"], lanes, unit_id, dc.p, dc.sparse_cap), reps
    )
    t = time.time()
    c.finalized_counts()
    finalize_s = time.time() - t

    n_units = max(units, 1)
    emit({
        "phase": "device_counters_python_route",
        "route": c.route,
        "reads": c.total_sequences,
        "run_s": run_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_phase4": run4["reads_per_s"],
        "reads_per_s_phase4_config_same_reads": N_READS_SINGLE / ref_s,
        "classify_s": classify_s,
        "finalize_s": finalize_s,
        "sparse_stats_ms_unit0": stats_ms,
        "units": units,
        "host_s_per_unit": c.host_seconds / n_units,
        "device_step_s_per_unit": c.device_seconds / n_units,
        "sparse_overflows": dc.tracker.overflows,
        "sparse_entries_unit0": n_used,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "equal_to_phase4_config": True,
    })
    return {"taxon_counts": counts, "hll_regmax": regmax}, launches


# ----------------------------------------------------------- phases 11, 12


def write_long_reads(path: str, genomes, short_path: str, seed: int = 5) -> list:
    """Phase 11's input: the first N_LONG_SHORT reads of `short_path` with a
    long read after every N_LONG_SHORT / N_LONG of them. Each long read's
    species is drawn zipf-1.5, as write_reads draws it, and its bases are
    LONG_MIN-LONG_MAX of the genome read as a circle from a random offset
    (bacterial chromosomes and plasmids are circular; the demo genomes are
    shorter than a long read). Returns the long reads' (id, sequence)."""
    rng = np.random.default_rng(seed)
    sids = list(genomes)
    wts = 1.0 / np.arange(1, len(sids) + 1, dtype=np.float64) ** 1.5
    gsel = np.searchsorted(np.cumsum(wts) / wts.sum(), rng.random(N_LONG))
    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=N_LONG)
    longs = []
    for i in range(N_LONG):
        sid = sids[gsel[i]]
        g = genomes[sid]
        off, n = int(rng.integers(0, len(g))), int(lens[i])
        longs.append((f"L{i}_{sid}", (g * ((off + n) // len(g) + 1))[off : off + n]))
    every = N_LONG_SHORT // N_LONG
    with open(short_path) as fin, open(path + ".tmp", "w") as f:
        for i in range(N_LONG_SHORT):
            f.write(fin.readline())
            f.write(fin.readline())
            if (i + 1) % every == 0:
                rid, seq = longs[(i + 1) // every - 1]
                f.write(f">{rid}\n{seq}\n")
    os.replace(path + ".tmp", path)
    return longs


def expand_hitlist(hitlist: str) -> np.ndarray:
    """A kraken line's hit list as one code per k-mer (-1 for A)."""
    parts = [p.rsplit(":", 1) for p in hitlist.split()]
    codes = np.array([-1 if t == "A" else int(t) for t, _ in parts], dtype=np.int64)
    return np.repeat(codes, [int(n) for _, n in parts])


def kraken_lines_by_id(path: str) -> dict:
    """{read id: the line's bytes} of a kraken output."""
    with open(path, "rb") as f:
        return {line.split(b"\t", 2)[1].decode(): line for line in f}


def phase_long_reads(run4, reps: int):
    """Long reads on phase 4's loaded database (Classifier.with_shared_db, no
    reload): phase 4's first N_LONG_SHORT reads with N_LONG reads of 33-100
    kbp among them (write_long_reads). The short reads' lines must be
    byte-equal to phase 4's; each long read's hit list covers L - k + 1
    k-mers and its per-k-mer taxa equal those of its chunks (max_read_len
    bases, k - 1 overlap) classified as ordinary reads by the span route;
    the long reads' calls are their species; a --device-counters run gives
    the same kraken bytes; the launches follow the plan: every long read
    one kmer_front and one chd_probe, and scores only in the short reads'
    steps (a unit or a span each). One long-read step is timed and split by
    operation on the card."""
    import dataclasses

    import torch

    from krakenuniq_tpu_torch.classify import Classifier
    from krakenuniq_tpu_torch.kmer import encode_batch

    c4 = run4["c"]
    k = c4.k
    db_dir = os.path.dirname(run4["kraken"])
    path = os.path.join(db_dir, f"long_reads_{N_LONG_SHORT}_{N_LONG}.fa")
    t = time.time()
    longs = write_long_reads(path, run4["genomes"], run4["reads"])
    write_s = time.time() - t
    long_bases = sum(len(seq) for _, seq in longs)

    c = Classifier.with_shared_db(c4)
    long_s = [0.0]
    classify_long = c._classify_long_read

    def timed_long(seq):
        t0 = time.perf_counter()
        res = classify_long(seq)  # returns host arrays: the card has finished
        long_s[0] += time.perf_counter() - t0
        return res

    c._classify_long_read = timed_long
    out_path, report_path = os.path.join(db_dir, "kraken_long.out"), os.path.join(db_dir, "report_long.tsv")
    run_s, classify_s, launches, peak = timed_run(c, path, out_path, report_path)
    steps = c.n_units + c.n_spans  # the short reads' steps
    log(f"long reads: {c.total_sequences} reads ({c.n_long_reads} long) in {run_s:.1f}s, {c.n_units} units, "
        f"{c.n_spans} spans, long-read route {long_s[0]:.1f}s, launches {launches}")
    want = {"scores": steps, "kmer_front": steps + N_LONG, "chd_probe": steps + N_LONG}
    if c.n_long_reads != N_LONG or c.total_sequences != N_LONG_SHORT + N_LONG or any(
            launches[kk] != v for kk, v in want.items()):
        raise AssertionError(f"long reads: {c.n_long_reads} long of {c.total_sequences}, launches {launches}, "
                             f"want {want}")

    # the short reads' lines are phase 4's
    got = kraken_lines_by_id(out_path)
    with open(run4["kraken"], "rb") as f:
        want_short = b"".join(line for _, line in zip(range(N_LONG_SHORT), f))
    with open(out_path, "rb") as f:
        short = b"".join(line for line in f if not line.split(b"\t", 2)[1].startswith(b"L"))
    if short != want_short:
        raise AssertionError("long reads: the short reads' lines differ from phase 4's")

    # each long read: its species, every k-mer in its hit list, and the
    # per-k-mer taxa of its chunks classified as ordinary reads
    mrl = c.opts.max_read_len
    payload = mrl - (k - 1)
    chunk_path = os.path.join(db_dir, f"long_read_chunks_{N_LONG}.fa")
    with open(chunk_path, "w") as f:
        for rid, seq in longs:
            for j, st in enumerate(range(0, len(seq) - k + 1, payload)):
                f.write(f">{rid}#{j}\n{seq[st : st + mrl]}\n")
    cc = Classifier.with_shared_db(c4)
    chunk_out = os.path.join(db_dir, "kraken_long_chunks.out")
    t = time.time()
    with open(chunk_out, "w") as kf:
        cc.run([chunk_path], kraken_fh=kf)
    chunks_s = time.time() - t
    if cc.n_units or cc.n_long_reads or cc.n_spans == 0:
        raise AssertionError(f"the chunks ran {cc.n_units} Python-route units and {cc.n_spans} spans")
    chunk_rows: dict = {}
    with open(chunk_out) as f:
        for line in f:
            cid, hl = line.split("\t")[1], line.rstrip("\n").split("\t")[4]
            chunk_rows.setdefault(cid.split("#")[0], []).append(expand_hitlist(hl))
    n_right = 0
    for rid, seq in longs:
        fields = got[rid].decode().rstrip("\n").split("\t")
        codes = expand_hitlist(fields[4])
        if int(fields[3]) != len(seq) or len(codes) != len(seq) - k + 1:
            raise AssertionError(f"long read {rid}: length {fields[3]}, {len(codes)} k-mers in its hit list")
        if not np.array_equal(codes, np.concatenate(chunk_rows[rid])):
            raise AssertionError(f"long read {rid}: its per-k-mer taxa differ from its chunks' on the span route")
        n_right += int(fields[2]) == int(rid.rsplit("_", 1)[1])
    if n_right < 0.99 * N_LONG:
        raise AssertionError(f"long reads: {n_right} of {N_LONG} called as their species")
    log(f"long reads: short lines == phase 4's, {N_LONG} hit lists == their chunks' on the span route "
        f"({cc.n_spans} spans, {chunks_s:.1f}s), {n_right} called right")

    # --device-counters: the same bytes
    cd = Classifier.with_shared_db(c4, device_counters=True)
    dc_paths = (os.path.join(db_dir, "kraken_long_dc.out"), os.path.join(db_dir, "report_long_dc.tsv"))
    dc_s, _, dc_launches, _ = timed_run(cd, path, *dc_paths)
    same_bytes([(dc_paths[0], out_path)])
    log(f"long reads, device counters: {dc_s:.1f}s, kraken output byte-equal")
    del cd

    # one long-read step (the longest read: ceil(L / payload) chunks in a
    # batch of 8 rows) on the card: timed, split by operation
    rid, seq = max(longs, key=lambda x: len(x[1]))
    chunks = [seq[st : st + mrl] for st in range(0, len(seq) - k + 1, payload)]
    enc = encode_batch(chunks, lb=mrl, batch=8)
    cfg = dataclasses.replace(c._cfg, resolve=False, max_runs=0, quick=False)
    step = lambda: c._device_step(enc.codes, enc.ambig, enc.lengths, cfg=cfg)
    step_ms = time_ms(step, reps)
    by_op = device_ms_by_op(step, reps=5)
    torch.cuda.synchronize()

    ooc_path = os.path.join(db_dir, f"long_reads_{N_LONG_OOC}.fa")
    with open(ooc_path, "w") as f:
        for rid, seq in longs[:N_LONG_OOC]:
            f.write(f">{rid}\n{seq}\n")
    run4["long_ooc"] = (ooc_path, b"".join(got[rid] for rid, _ in longs[:N_LONG_OOC]))
    emit({
        "phase": "long_reads",
        "reads": c.total_sequences,
        "long_reads": c.n_long_reads,
        "long_read_bases": long_bases,
        "input_write_s": write_s,
        "run_s": run_s,
        "classify_s": classify_s,
        "reads_per_s": c.total_sequences / run_s,
        "long_route_s": long_s[0],
        "long_reads_per_s": N_LONG / long_s[0],
        "long_mbp_per_s": long_bases / long_s[0] / 1e6,
        "ms_per_long_read": 1e3 * long_s[0] / N_LONG,
        "long_step_shape": list(enc.codes.shape),
        "long_step_ms": step_ms,
        "long_step_device_ms_by_op": by_op,
        "units": c.n_units,
        "spans": c.n_spans,
        "calls_right": n_right,
        "chunks_as_reads_s": chunks_s,
        "chunks_as_reads_spans": cc.n_spans,
        "device_counters_run_s": dc_s,
        "device_counters_launches": dc_launches,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "short_lines_equal_to_phase4": True,
    })
    return launches


def report_rows(path: str) -> list:
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def phase_exact(run4):
    """--exact on phase 4's loaded database (Classifier.with_shared_db, no
    reload), on phase 4's first N_READS_SINGLE reads on the span route (a
    cut from all of phase 4's reads that keeps the script within its time
    limit): the kraken output byte-equal to phase 4's configuration on the
    same reads (phase 5b's reference run), every report column but kmers,
    dup and cov equal to its report; then the same reads with
    --device-counters (the counts-only state on the card), kraken output and
    report byte-equal to the host fold's, the counters' kernel once a span
    and no register or sparse-stats kernel."""
    from krakenuniq_tpu_torch.classify import Classifier

    db_dir = os.path.dirname(run4["kraken"])
    sub = head_reads(run4["reads"], N_READS_SINGLE)
    ref = (os.path.join(db_dir, "kraken_sub.out"), os.path.join(db_dir, "report_sub.tsv"))  # phase 5b's
    c = Classifier.with_shared_db(run4["c"], exact=True)
    paths = (os.path.join(db_dir, "kraken_exact.out"), os.path.join(db_dir, "report_exact.tsv"))
    run_s, classify_s, launches, peak = timed_run(c, sub, *paths)
    spans = max(c.n_spans, 1)
    log(f"exact: {c.total_sequences} reads in {run_s:.1f}s ({classify_s:.1f}s before the report), {c.n_spans} spans, "
        f"launches {launches}")
    want = {"kmer_front": c.n_spans, "chd_probe": c.n_spans, "scores": c.n_spans, "pack_runs": c.n_spans}
    if c.route != "span" or c.n_units or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"exact: route {c.route}, {c.n_units} units, launches {launches}, want {want}")
    same_bytes([(paths[0], ref[0])])
    got, base = report_rows(paths[1]), report_rows(ref[1])
    keep = [i for i in range(len(base[0])) if base[0][i] not in ("kmers", "dup", "cov")]
    if len(got) != len(base) or any([a[i] for i in keep] != [b[i] for i in keep] for a, b in zip(got, base)):
        raise AssertionError("exact: the report differs from phase 4's configuration outside kmers, dup and cov")
    n_kmers_diff = sum(a[3] != b[3] for a, b in zip(got[1:], base[1:]))
    log(f"exact: kraken output byte-equal to phase 4's configuration, report equal outside kmers/dup/cov "
        f"({n_kmers_diff} of {len(base) - 1} k-mer counts differ from the HLL estimates)")

    cs = Classifier.with_shared_db(run4["c"], exact=True, device_counters=True)
    dc_paths = (os.path.join(db_dir, "kraken_exact_dc.out"), os.path.join(db_dir, "report_exact_dc.tsv"))
    dc_s, _, dc_launches, _ = timed_run(cs, sub, *dc_paths)
    want = {"taxon_counts": cs.n_spans, "hll_regmax": 0, "sparse_stats": 0, "sparse_keys": 0}
    if not cs.dev_counters.counts_only or any(dc_launches[k] != v for k, v in want.items()):
        raise AssertionError(f"exact, device counters: counts_only {cs.dev_counters.counts_only}, "
                             f"launches {dc_launches}")
    same_bytes(zip(dc_paths, paths))
    log(f"exact on {N_READS_SINGLE} reads: the device-counters output and report byte-equal to the host fold's")
    emit({
        "phase": "exact",
        "reads": c.total_sequences,
        "run_s": run_s,
        "classify_s": classify_s,
        "reads_per_s": c.total_sequences / run_s,
        "reads_per_s_phase4": run4["reads_per_s"],
        "spans": c.n_spans,
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "kmer_counts_differing": n_kmers_diff,
        "taxa": len(base) - 1,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "device_counters": {"run_s": dc_s, "reads_per_s": cs.total_sequences / dc_s, "spans": cs.n_spans,
                            "launches": dc_launches},
        "kraken_equal_to_phase4_config": True,
    })
    return launches


# ------------------------------------------------------------------ phase 6


def phase_uid(run4, reps: int):
    """UID databases (--uid-mapping): phase 4's genome keys under the UID
    values of write_uid_db, in uid_genome_dir beside phase 4's database,
    loaded cold by Classifier(..., uid_database=True) (the port's caches of
    uid_database.kdb removed first: a raw two-level table of 201 MB on the
    card; all 111M keys of phase 4 make a 3.2 GB one, which only
    --uid-ooc-only loads). Phase 4's first
    N_READS_UID reads on the span route: at least 99% called as their
    species, rows_probe, kmer_front, scores and pack_runs once a span and
    chd_probe never, no Python-route unit; a --device-counters run byte-equal
    (kraken output and report); the first N_READS_UID_PY reads through the
    Python route, their lines byte-equal to the span route's; N_LONG_UID of
    phase 11's long reads, each called as its species (resolve_uids on the
    host); one span step equal to the same step forced to the plain
    versions, and rows_probe on that span's hashes and the real planes.
    Returns (rows_probe's record, the span run's launches)."""
    import torch

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.classify.device_step import kmer_front_words

    db_dir = uid_genome_dir(os.path.dirname(run4["kraken"]))
    t = time.time()
    if run4["synth"] is not None:  # the synthesis process writes it while phase 4 runs
        uid_write_s = finish_uid_synthesis(run4["synth"])
        log(f"waited {time.time() - t:.1f}s for the UID database ({uid_write_s:.1f}s of synthesis)")
    else:
        uid_write_s = ensure_uid_genome_db(os.path.dirname(run4["kraken"]), run4["genomes"])
    reads = head_reads(run4["reads"], N_READS_UID)
    remove_port_caches(db_dir, "uid_database.kdb")
    t = time.time()
    c = Classifier([db_dir], ClassifyOptions(print_progress=False, device="cuda"), uid_database=True)
    load_s = time.time() - t
    db = c.dbs[0]
    log(f"UID database loaded in {load_s:.1f}s {db.timings}; lb={db.hash_lb}, {db.table_bytes / 1e9:.3f} GB "
        f"raw planes, {len(c.uid_map)} UIDs")
    if not db.store_raw or db.timings.get("cache") != "miss" or c.route != "span":
        raise AssertionError(f"UID load: store_raw {db.store_raw}, {db.timings}, {c.route} route")

    paths = {kind: (os.path.join(db_dir, f"kraken_uid{kind}.out"), os.path.join(db_dir, f"report_uid{kind}.tsv"))
             for kind in ("", "_dc", "_py", "_long")}
    with contextlib.redirect_stderr(io.StringIO()):  # the report names every UID with no taxon
        run_s, classify_s, launches, peak = timed_run(c, reads, *paths[""])
    spans = max(c.n_spans, 1)
    log(f"UID: {c.total_sequences} reads in {run_s:.1f}s ({classify_s:.1f}s classify), {c.n_spans} spans, "
        f"launches {launches}")
    want = {n: c.n_spans for n in ("rows_probe", "kmer_front", "scores", "pack_runs")}
    if c.n_units or launches["chd_probe"] or any(launches[n] != v for n, v in want.items()):
        raise AssertionError(f"UID: {c.n_units} Python-route units, launches {launches}, want {want}")
    n_right = n_lines = 0
    with open(paths[""][0]) as f:
        for line in f:
            _, rid, call = line.split("\t", 3)[:3]
            n_lines += 1
            n_right += int(call) == int(rid.rsplit("_", 1)[1])
    if n_lines != N_READS_UID or n_right < 0.99 * N_READS_UID:
        raise AssertionError(f"UID: {n_lines} lines, {n_right} called as their species")

    cd = Classifier.with_shared_db(c, device_counters=True)
    with contextlib.redirect_stderr(io.StringIO()):
        dc_s, _, dc_launches, _ = timed_run(cd, reads, *paths["_dc"])
    same_bytes(zip(paths["_dc"], paths[""]))
    if cd.dev_counters.tracker.overflows or not all(dc_launches[n] for n in ("taxon_counts", "hll_regmax")):
        raise AssertionError(f"UID device counters: {cd.dev_counters.tracker.overflows} overflows, "
                             f"launches {dc_launches}")
    log(f"UID, device counters: {dc_s:.1f}s, kraken output and report byte-equal")
    del cd

    cp = Classifier.with_shared_db(c, use_native=False)
    with contextlib.redirect_stderr(io.StringIO()):
        py_s, _, _, _ = timed_run(cp, head_reads(reads, N_READS_UID_PY), *paths["_py"])
    with open(paths[""][0], "rb") as f:
        head = b"".join(line for _, line in zip(range(N_READS_UID_PY), f))
    with open(paths["_py"][0], "rb") as f:
        if f.read() != head or cp.n_units == 0:
            raise AssertionError("UID: the Python route's lines differ from the span route's")
    log(f"UID, Python route: {N_READS_UID_PY} reads in {py_s:.1f}s, lines byte-equal to the span route's")
    del cp

    long_path = os.path.join(db_dir, f"long_reads_uid_{N_LONG_UID}.fa")
    with open(run4["long_ooc"][0]) as f, open(long_path, "w") as g:
        g.writelines(line for _, line in zip(range(2 * N_LONG_UID), f))
    cl = Classifier.with_shared_db(c)
    with contextlib.redirect_stderr(io.StringIO()):
        long_s, _, long_launches, _ = timed_run(cl, long_path, *paths["_long"])
    with open(paths["_long"][0]) as f:
        long_right = sum(int(line.split("\t")[2]) == int(line.split("\t")[1].rsplit("_", 1)[1]) for line in f)
    if cl.n_long_reads != N_LONG_UID or long_right != N_LONG_UID or long_launches["rows_probe"] < N_LONG_UID:
        raise AssertionError(f"UID long reads: {cl.n_long_reads} long, {long_right} called right, "
                             f"launches {long_launches}")
    log(f"UID, long reads: {N_LONG_UID} in {long_s:.1f}s, each called as its species")
    del cl

    kind, buf, offs, _, _ = next(c._iter_native_spans(reads))
    codes_w, ambig_w, lengths_np = c._encode_span(buf, offs)
    out_k = c._span_step(codes_w, ambig_w, lengths_np)
    out_p = c._span_step(codes_w, ambig_w, lengths_np, plain=True)
    torch.cuda.synchronize()
    for key in out_p:
        if not torch.equal(out_k[key], out_p[key]):
            raise AssertionError(f"UID span: kernel step differs from plain step in {key!r}")
    cw, aw = (torch.from_numpy(a.view(np.int32)).cuda() for a in (codes_w, ambig_w))
    hashes, _, kmer_ambig = kmer_front_words(cw, aw, c.k, c._cfg.hll_p)
    lengths = torch.from_numpy(lengths_np).cuda()
    search = (torch.arange(hashes.shape[1], device="cuda")[None, :]
              < (lengths - (c.k - 1)).clamp(min=0)[:, None]) & ~kmer_ambig
    _, rec = rows_case("rows_probe", c._db_planes[0], hashes, search, reps, 103)
    by_op = device_ms_by_op(lambda: c._span_step(codes_w, ambig_w, lengths_np), reps=5)
    emit({
        "phase": "uid",
        "route": c.route,
        "db_keys": int(db.key_ct),
        "uids": len(c.uid_map),
        "uid_db_write_s": uid_write_s,
        "table_gb": db.table_bytes / 1e9,
        "lb": db.hash_lb,
        "load_s": load_s,
        "load_steps_s": db.timings,
        "reads": c.total_sequences,
        "run_s": run_s,
        "classify_s": classify_s,
        "reads_per_s": c.total_sequences / run_s,
        "spans": c.n_spans,
        "span_shape": list(codes_w.shape),
        "host_s_per_span": c.host_seconds / spans,
        "host_s_per_span_by_stage": {k: v / spans for k, v in c.span_host_seconds.items()},
        "uid_resolve_s_per_span": c.span_host_seconds["uid"] / spans,
        "device_s_per_span": c.device_seconds / spans,
        "fetch_ms_per_span": 1e3 * c.fetch_seconds / spans,
        "span_step_device_ms_by_op": by_op,
        "calls_right": n_right,
        "device_counters_run_s": dc_s,
        "device_counters_launches": dc_launches,
        "python_route_reads": N_READS_UID_PY,
        "python_route_s": py_s,
        "long_reads": N_LONG_UID,
        "long_reads_s": long_s,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
    })
    return rec, launches


# ----------------------------------------------------------------- phase 14


def build_dir(n_species, genome_len, pad_nodes) -> str:
    """Phase 14's database directory under the port's _build/: phase 4's
    genomes as a library and its taxonomy as NCBI dumps, built there by the
    port's build CLI."""
    return os.path.join(ROOT, "krakenuniq_tpu_torch", "_build", f"build_db_{n_species}_{genome_len}_{pad_nodes}")


def write_build_inputs(d: str, genomes, tax) -> None:
    """Phase 14's inputs: library/genomes.fna (one line a genome, seqid
    g<taxid>) with library/genomes.map, and taxonomy/{names,nodes}.dmp
    written from phase 4's taxonomy by the port's dump-taxdb tool; the
    marker `inputs.done` last."""
    from krakenuniq_tpu_torch.cli.tools import dump_taxdb_main

    t = time.time()
    for sub in ("library", "taxonomy"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    with open(os.path.join(d, "library", "genomes.fna"), "w") as f, \
            open(os.path.join(d, "library", "genomes.map"), "w") as m:
        for sid in sorted(genomes):
            f.write(f">g{sid}\n{genomes[sid]}\n")
            m.write(f"g{sid}\t{sid}\n")
    src = os.path.join(d, "taxDB.phase4")
    tax.write_taxdb(src)
    dump_taxdb_main([src, os.path.join(d, "taxonomy", "names.dmp"), os.path.join(d, "taxonomy", "nodes.dmp")])
    os.unlink(src)
    open(os.path.join(d, "inputs.done"), "w").close()
    log(f"build inputs written: {len(genomes)} genomes, {tax.size} taxonomy nodes in {time.time() - t:.1f}s")


def genome_keys(genomes, k: int):
    """Phase 4's genome keys made again from its genomes as make_demo_db
    makes them: (keys sorted, each key's value (its first genome's species,
    make_demo_db's tie rule), keys held by more than one species, the number
    of distinct forward k-mers)."""
    from krakenuniq_tpu_torch.utils.bits import canonical_representation
    from krakenuniq_tpu_torch.utils.demo import _host_pack_windows

    species = np.asarray(sorted(genomes), dtype=np.uint32)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = np.stack([lut[np.frombuffer(genomes[int(s)].encode(), np.uint8)] for s in species])
    fwd = _host_pack_windows(codes, k)
    flat = np.sort(fwd, axis=None)
    n_fwd = int(1 + np.count_nonzero(flat[1:] != flat[:-1]))
    del flat
    kmers = canonical_representation(fwd.reshape(-1), k)
    sp = np.repeat(np.arange(len(species), dtype=np.uint32), fwd.shape[1])
    order = np.argsort(kmers, kind="stable")  # species ascend along the array: lexsort((sp, kmers))
    skeys, ssp = kmers[order], sp[order]
    first = np.concatenate([[True], skeys[1:] != skeys[:-1]])
    starts = np.flatnonzero(first)
    # a key held by two species: its segment's last species differs from its first
    last = np.concatenate([starts[1:], [len(skeys)]]) - 1
    shared = skeys[starts][ssp[last] != ssp[starts]]
    return skeys[starts], species[ssp[starts]], shared, n_fwd


class _Rss:
    """Peak resident set of this process while a block runs (sampled from
    /proc/self/statm every 20 ms on a thread)."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self.read()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()
        return self

    def read(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def sample(self):
        while not self.stop.wait(0.02):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.read())


@contextlib.contextmanager
def build_clock(after_taxdb=None, after_load=None, after_simulate=None):
    """Time what build_main and the accuracy loop call: wraps the taxDB
    step (Taxonomy.from_ncbi_dumps, write_taxdb), the LCA build
    (stream_database_to_dir, with the peak RSS), step 6b (the classify CLI's
    main, every launch counter reset just before and read just after), the
    Classifier's load (__init__), run and write_report, the UID build, and
    the accuracy loop's simulation and grading. Yields a dict: "steps" maps
    each label to its calls' (start, end, result), "launches" the counters
    after step 6b, "classifiers" each Classifier made, "rss" the LCA
    build's (start, peak) bytes. `after_taxdb`, `after_load` and
    `after_simulate` are called when the taxDB step has written taxDB, when
    a Classifier has loaded and when the accuracy loop's simulation has
    ended."""
    import torch

    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.build import db_build, uid_build
    from krakenuniq_tpu_torch.classify import pipeline
    from krakenuniq_tpu_torch.cli import main as cli_main
    from krakenuniq_tpu_torch.report import accuracy
    from krakenuniq_tpu_torch.taxonomy import Taxonomy

    clock = {"steps": {}, "launches": None, "classifiers": [], "rss": None}

    def timed(label, fn, before=None, after=None):
        def wrapper(*a, **kw):
            if before is not None:
                before()
            t = time.time()
            if label == "lca":
                with _Rss() as rss:
                    out = fn(*a, **kw)
                clock["rss"] = (rss.start, rss.peak)
            else:
                out = fn(*a, **kw)
            if after is not None:
                after()
            clock["steps"].setdefault(label, []).append((t, time.time(), out))
            return out
        return wrapper

    def reset():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        _kernels.reset_launches()

    def read():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        clock["launches"] = dict(_kernels.LAUNCHES)

    init = pipeline.Classifier.__init__

    def init_wrapper(self, *a, **kw):
        init(self, *a, **kw)
        clock["classifiers"].append(self)
        if after_load is not None:
            after_load()

    patches = [
        (Taxonomy, "from_ncbi_dumps", classmethod(timed("from_dumps", Taxonomy.from_ncbi_dumps.__func__))),
        (Taxonomy, "write_taxdb", timed("write_taxdb", Taxonomy.write_taxdb, after=after_taxdb)),
        (db_build, "stream_database_to_dir", timed("lca", db_build.stream_database_to_dir)),
        (cli_main, "main", timed("6b", cli_main.main, reset, read)),
        (pipeline.Classifier, "__init__", timed("load", init_wrapper)),
        (pipeline.Classifier, "run", timed("classify", pipeline.Classifier.run)),
        (pipeline.Classifier, "write_report", timed("report", pipeline.Classifier.write_report)),
        (uid_build, "build_uid_database", timed("uid", uid_build.build_uid_database)),
        (accuracy, "write_simulated_fasta", timed("simulate", accuracy.write_simulated_fasta, after=after_simulate)),
        (accuracy, "grade", timed("grade", accuracy.grade)),
    ]
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield clock
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


def seconds(clock, label: str, i: int = 0) -> float:
    start, end, _ = clock["steps"][label][i]
    return end - start


def first_difference(got_path: str, want_path: str, reads: str, k: int) -> str:
    """Where two kraken outputs part: the first differing line of each and,
    from the read's sequence, the first k-mer whose hit differs."""
    from krakenuniq_tpu_torch.utils.bits import canonical_representation

    with open(got_path) as g, open(want_path) as w:
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                break
        else:
            return "one output is a prefix of the other"
    with open(reads) as f:
        for j, line in enumerate(f):
            if j == 2 * i + 1:
                seq = line.strip()
                break
    ha, hb = expand_hitlist(a.rstrip("\n").split("\t")[4]), expand_hitlist(b.rstrip("\n").split("\t")[4])
    n = min(len(ha), len(hb))
    diff = np.flatnonzero(ha[:n] != hb[:n])
    pos = int(diff[0]) if len(diff) else 0
    fwd = 0
    for ch in seq[pos:pos + k]:
        fwd = (fwd << 2) | "ACGT".index(ch)
    kmer = int(canonical_representation(np.asarray([fwd], np.uint64), k)[0])
    return f"line {i + 1}: {a.strip()!r} against {b.strip()!r}; k-mer {pos} (canonical {kmer}): {ha[pos]} against {hb[pos]}"


def report_table(path: str, cols) -> dict:
    """{taxid: the row's fields at cols} of a Classifier report's data rows."""
    out = {}
    with open(path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) > 6 and fields[6].isdigit():
                out[int(fields[6])] = tuple(fields[c] for c in cols)
    return out


def run_tools(db_dir: str, kraken: str, report: str, reads: str) -> dict:
    """The post-processing tools at full size on phase 4's outputs, each
    through its function in krakenuniq_tpu_torch.report, each timed and
    checked: report (read and clade counts equal to phase 4's report's),
    translate plain and --mpa-format (a line for each classified read, in
    input order), mpa-report (its species rows' counts equal to phase 4's
    clade counts of the species), filter (a line for each read, in input
    order) and extract-reads of the most-called species (exactly the reads
    whose lines call it). Returns {tool: {"s", "rows"}}."""
    from collections import Counter

    from krakenuniq_tpu_torch.report.extract_reads import extract_reads
    from krakenuniq_tpu_torch.report.postprocess import basic_report, filter_output, mpa_report, translate

    with open(kraken) as f:
        ids, calls, classified = [], [], []
        for line in f:
            st, rid, call = line.split("\t", 3)[:3]
            ids.append(rid)
            calls.append(int(call))
            classified.append(st == "C")
    c_ids = [r for r, c in zip(ids, classified) if c]
    out, recs = {}, {}
    want = {t: v for t, v in report_table(report, (1, 2)).items() if v != ("0", "0")}
    path = os.path.join(os.path.dirname(kraken), "tool_out.txt")

    def run(name, call):
        t = time.time()
        with open(path, "w") as fh:
            res = call(fh)
        s = time.time() - t
        with open(path) as fh:
            rows = fh.read().splitlines()
        out[name] = {"s": s, "rows": len(rows)}
        recs[name] = (res, rows)
        log(f"tool {name}: {len(rows)} rows in {s:.1f}s")
        return rows

    rows = run("report", lambda fh: basic_report(db_dir, [kraken], fh))
    got = {int(r.split("\t")[4]): (r.split("\t")[1], r.split("\t")[2]) for r in rows}
    got = {t: v for t, v in got.items() if v != ("0", "0")}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:5]
        raise AssertionError(f"report: read and clade counts differ from phase 4's report: {bad}")
    for name, mpa in (("translate", False), ("translate --mpa-format", True)):
        rows = run(name, lambda fh: translate(db_dir, [kraken], fh, mpa_format=mpa))
        if [r.split("\t", 1)[0] for r in rows] != c_ids:
            raise AssertionError(f"{name}: not a line for each classified read in input order")
    rows = run("mpa-report", lambda fh: mpa_report(db_dir, [kraken], fh))
    species = {t: v[0] for t, v in want.items() if t >= 10_000_000}  # phase 4's species ids
    s_rows = sorted(int(r.rsplit("\t", 1)[1]) for r in rows if "|s__" in r)
    if s_rows != sorted(int(v) for v in species.values()):
        raise AssertionError("mpa-report: its species rows' counts differ from phase 4's clade counts")
    rows = run("filter", lambda fh: filter_output(db_dir, [kraken], fh, threshold=0.5))
    if [r.split("\t", 2)[1] for r in rows] != ids:
        raise AssertionError("filter: not a line for each read in input order")
    top = Counter(calls).most_common(1)[0][0]
    rows = run("extract-reads", lambda fh: extract_reads([top], kraken, reads, fh, fasta_input=True))
    got_ids = [r[1:] for r in rows if r.startswith(">")]
    want_ids = [r for r, c in zip(ids, calls) if c == top]
    if got_ids != want_ids or recs["extract-reads"][0] != len(want_ids):
        raise AssertionError(f"extract-reads {top}: {len(got_ids)} reads, {len(want_ids)} lines call it")
    out["extract-reads"]["taxid"] = top
    os.unlink(path)
    return out


def _tools_child(queue, paths) -> None:
    """The body of start_tools' process: run_tools on phase 4's outputs;
    puts its result."""
    queue.put(run_tools(*paths))


def start_tools(run4):
    """Start phase 14's tools (host numpy and Python, no card) on phase 4's
    outputs in a child process beside phases 5-13; phase_build waits for it
    (finish_tools). Returns (process, queue)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    paths = (os.path.dirname(run4["kraken"]), run4["kraken"], run4["report"], run4["reads"])
    proc = ctx.Process(target=_tools_child, args=(queue, paths), daemon=True)
    proc.start()
    return proc, queue


def table_digest(planes) -> str:
    """sha256 over a table's planes, fetched to the host."""
    import hashlib

    h = hashlib.sha256()
    for p in planes:
        h.update(p.cpu().numpy().tobytes())
    return h.hexdigest()


def _accuracy_child(queue, taxdb_ready, cache_ready, d: str, device: str, n_reads: int, error: float) -> None:
    """The body of start_accuracy's process: simulate_and_grade on the built
    database with every launch counter reset just before; puts ("reads",
    path) when the reads are written. Its Classifier reads taxDB once the
    build has written it (`taxdb_ready`) and the table once step 6b has
    loaded the database and written its table cache (`cache_ready`), so that
    it loads warm; puts the loop's result, its waits apart."""
    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.classify import ClassifyOptions, pipeline
    from krakenuniq_tpu_torch.report.accuracy import simulate_and_grade

    work = os.path.join(d, "accuracy")
    waits = {"taxdb": 0.0, "cache": 0.0}

    def gated(fn, event, what):
        def wrapper(*a, **kw):
            t = time.time()
            if not event.wait(timeout=1800):
                raise RuntimeError(f"the build never got to {what}")
            waits[what] += time.time() - t
            return fn(*a, **kw)
        return wrapper

    read_taxdb = pipeline.Taxonomy.__dict__["from_taxdb_file"]
    pipeline.Taxonomy.from_taxdb_file = classmethod(gated(read_taxdb.__func__, taxdb_ready, "taxdb"))
    pipeline.load_database_dir = gated(pipeline.load_database_dir, cache_ready, "cache")
    _kernels.reset_launches()
    t = time.time()
    with build_clock(after_simulate=lambda: queue.put(("reads", os.path.join(work, "simulated.fa")))) as clock:
        stats, files = simulate_and_grade(d, work, n_reads=n_reads, read_len=150, error_rate=error, seed=1,
                                          classify_options=ClassifyOptions(print_progress=False, device=device))
    loop_s = time.time() - t
    db = clock["classifiers"][0].dbs[0]
    queue.put({
        "stats": stats, "files": files, "loop_s": loop_s, "launches": dict(_kernels.LAUNCHES),
        **{f"{k}_s": seconds(clock, k) for k in ("simulate", "classify", "grade")},
        "load_s": seconds(clock, "load") - sum(waits.values()), "waits_s": waits,
        "load_steps_s": db.timings, "table_digest": table_digest(db.hash_table),
    })


def start_accuracy(d: str, device: str):
    """Start phase 14's accuracy loop (simulate_and_grade on the card) in a
    child process beside the build: its reads' simulation and taxonomy read
    beside the build's first steps (set the first returned event when taxDB
    is written), its table once step 6b has loaded the database (the
    second), and its grading (Python loops) beside the rest of the build and
    the main process's checks. Returns ((process, queue), taxDB event,
    table event)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue, taxdb_ready, cache_ready = ctx.Queue(), ctx.Event(), ctx.Event()
    proc = ctx.Process(target=_accuracy_child, daemon=True,
                       args=(queue, taxdb_ready, cache_ready, d, device, N_SIM_READS, SIM_ERROR))
    proc.start()
    return (proc, queue), taxdb_ready, cache_ready


def phase_build(run4, tools=None, device: str = "cuda") -> tuple[dict, dict]:
    """The build and the host tools (phase 14). Phase 4's genomes and
    taxonomy (written as library/genomes.fna + .map and NCBI dumps by the
    synthesis process) built by the port's build CLI (`build_main([--db D,
    --kmer-len 31, --minimizer-len 12, --uid-database])`): each step's
    seconds, the LCA build's keys/s and peak RSS, step 6b's launches (every
    counter reset just before it; kmer_front, chd_probe, scores and
    pack_runs must launch) and route; the built kdb against phase 4's
    genome keys and species, the built taxDB against phase 4's, every
    library sequence self-called as its species. The accuracy loop
    (simulate_and_grade, N_SIM_READS reads at SIM_ERROR substitutions) runs
    in a child process beside the build, its load after step 6b's: a warm
    load (step 6b's cached table, the same bytes), within
    tests/test_simulated_accuracy.py's bounds. Meanwhile phase 4's reads against the built database (on step
    6b's loaded tables), kraken output byte-equal to phase 4's and the
    report equal outside cov; the loop's reads against the built UID
    database, the same calls; count-unique on the library; the tools'
    results from start_tools' process. Emits one `tools` line; returns
    its dict and the run of phase 4's reads against the built database
    (the reference of phases 7-10 and 8, which run on that database: the
    keys of `run`, phase 4's)."""
    import shutil

    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.cli.build_main import main as build_main
    from krakenuniq_tpu_torch.cli.tools import count_unique_main
    from krakenuniq_tpu_torch.formats import read_kdb

    k = 31
    cuda = device == "cuda"
    d = build_dir(N_SPECIES, GENOME_LEN, PAD_NODES)
    if not os.path.exists(os.path.join(d, "inputs.done")):  # no synthesis process wrote them
        from krakenuniq_tpu_torch.utils.demo import make_demo_taxonomy

        write_build_inputs(d, run4["genomes"], make_demo_taxonomy(N_SPECIES, 10_000_000, PAD_NODES)[0])
    for name in os.listdir(d):  # a directory kept from an earlier run: start from the inputs
        if name not in ("library", "taxonomy", "inputs.done"):
            path = os.path.join(d, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.unlink(path)

    # the build, step by step, beside the accuracy loop's process: its load
    # waits for step 6b's
    acc, taxdb_ready, cache_ready = start_accuracy(d, device)
    t = time.time()
    with build_clock(after_taxdb=taxdb_ready.set, after_load=cache_ready.set) as clock:
        rc = build_main(["--db", d, "--kmer-len", str(k), "--minimizer-len", "12", "--uid-database",
                         "--device", device])
    build_s = time.time() - t
    if rc != 0:
        raise AssertionError(f"build_main returned {rc}")
    st = clock["steps"]
    lca = st["lca"][0][2]
    cold = clock["classifiers"][0]
    split = {
        "taxdb_s": st["write_taxdb"][0][1] - st["from_dumps"][0][0],
        "seqid_map_s": st["lca"][0][0] - st["write_taxdb"][0][1],
        "lca_s": seconds(clock, "lca"),
        "counts_s": st["6b"][0][0] - st["lca"][0][1],
        "step_6b_s": seconds(clock, "6b"),
        "step_6b_load_s": seconds(clock, "load"),
        "step_6b_classify_s": seconds(clock, "classify"),
        "step_6b_report_s": seconds(clock, "report"),
        "uid_s": seconds(clock, "uid"),
        "total_s": build_s,
    }
    launches_6b, rss = clock["launches"], clock["rss"]
    step_6b = {"route": cold.route, "spans": cold.n_spans, "units": cold.n_units, "long_reads": cold.n_long_reads,
               "load_steps_s": cold.dbs[0].timings, "launches": launches_6b}
    log(f"built {lca['key_ct']} keys in {build_s:.1f}s {split}; 6b on the {cold.route} route, launches {launches_6b}")
    missing = [n for n in ("kmer_front", "chd_probe", "scores", "pack_runs") if cuda and not launches_6b[n]]
    if missing:
        raise AssertionError(f"step 6b launched no {missing} kernel: {launches_6b}")
    if cold.dbs[0].timings.get("cache") != "miss":
        raise AssertionError(f"step 6b's load was not a cold build: {cold.dbs[0].timings}")
    cold_digest = table_digest(cold.dbs[0].hash_table)

    # the built database against phase 4's genome keys and tree
    t = time.time()
    _, bkeys, bvals = read_kdb(os.path.join(d, "database.kdb"))
    gkeys, gvals, shared, n_fwd = genome_keys(run4["genomes"], k)
    order = np.argsort(bkeys)
    bkeys, bvals = np.asarray(bkeys)[order], np.asarray(bvals)[order]
    if not np.array_equal(bkeys, gkeys):
        raise AssertionError(f"built keys differ from phase 4's genome keys: {len(bkeys)} against {len(gkeys)}, "
                             f"{len(np.setxor1d(bkeys, gkeys))} in one only")
    differ = np.flatnonzero(bvals != gvals)
    tie = np.isin(bkeys[differ], shared)
    if not tie.all():
        bad = differ[~tie][:5]
        raise AssertionError(f"built values differ from phase 4's species off the shared keys: "
                             f"{list(zip(bkeys[bad].tolist(), bvals[bad].tolist(), gvals[bad].tolist()))}")
    with open(os.path.join(d, "taxDB"), "rb") as f, \
            open(os.path.join(os.path.dirname(run4["kraken"]), "taxDB"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the built taxDB differs from phase 4's")
    with open(os.path.join(d, "database.kraken.tsv")) as f:
        self_calls = [line.split("\t")[:3] for line in f]
    if len(self_calls) != len(run4["genomes"]) or any(s != "C" or r != f"g{c}" for s, r, c in self_calls):
        raise AssertionError(f"step 6b: {len(self_calls)} lines, not every library sequence called as its species")
    check_s = time.time() - t
    log(f"built kdb: {len(bkeys)} keys = phase 4's genome keys, {len(shared)} held by two species "
        f"({int(tie.sum())} of them the LCA where phase 4 keeps the first genome); taxDB byte-equal; "
        f"{len(self_calls)} library sequences called as their species ({check_s:.1f}s)")
    del bkeys, bvals, gkeys, gvals

    # phase 4's reads against the built database, on step 6b's tables
    c = Classifier.with_shared_db(cold, print_progress=False)
    del cold, clock
    out_path, rep_path = os.path.join(d, "kraken_phase4.out"), os.path.join(d, "report_phase4.tsv")
    run_s, classify_s, launches, peak = timed_run(c, run4["reads"], out_path, rep_path)
    with open(out_path, "rb") as f, open(run4["kraken"], "rb") as g:
        if f.read() != g.read():
            raise AssertionError("phase 4's reads against the built database: " +
                                 first_difference(out_path, run4["kraken"], run4["reads"], k))
    cols = (0, 1, 2, 3, 4, 7, 8)  # all but cov: the built database holds no ballast keys
    if report_table(rep_path, cols) != report_table(run4["report"], cols):
        raise AssertionError("phase 4's reads against the built database: the report differs outside cov")
    log(f"phase 4's reads against the built database: {run_s:.1f}s, kraken output byte-equal, report equal "
        f"outside cov")
    built_run = {"reads": run4["reads"], "kraken": out_path, "report": rep_path, "reads_per_s": N_READS / run_s,
                 "genomes": run4["genomes"], "synth": None,
                 **{key: run4[key] for key in ("long_ooc",) if key in run4}}
    del c
    gc.collect()

    # the loop's reads against the built UID database
    sim_reads = _child_next(acc, "the accuracy loop's process")[1]
    opts = ClassifyOptions(print_progress=False, device=device)
    t = time.time()
    cu = Classifier([d], opts, uid_database=True)
    uid_load_s = time.time() - t
    uid_out, uid_rep = os.path.join(d, "accuracy", "uid.kraken.tsv"), os.path.join(d, "accuracy", "uid.report.tsv")
    with contextlib.redirect_stderr(io.StringIO()):  # the report names every UID with no taxon
        uid_run_s, _, uid_launches, _ = timed_run(cu, sim_reads, uid_out, uid_rep)
    if (cuda and not uid_launches["rows_probe"]) or not cu.dbs[0].store_raw:
        raise AssertionError(f"UID database: store_raw {cu.dbs[0].store_raw}, launches {uid_launches}")
    del cu

    # count-unique on the library
    t = time.time()
    old_in, old_out = sys.stdin, sys.stdout
    with open(os.path.join(d, "library", "genomes.fna")) as lib:
        sys.stdin, sys.stdout = lib, io.StringIO()
        try:
            count_unique_main(["-k", str(k)])
            estimate = int(sys.stdout.getvalue())
        finally:
            sys.stdin, sys.stdout = old_in, old_out
    cu_s = time.time() - t
    if abs(estimate - n_fwd) > 0.05 * n_fwd:
        raise AssertionError(f"count-unique: {estimate} against {n_fwd} distinct k-mers")

    # the accuracy loop's result, then the UID calls against its calls
    t = time.time()
    loop = _synth_result(acc, "the accuracy loop's process")
    log(f"waited {time.time() - t:.1f}s for the accuracy loop's process")
    stats = loop["stats"]
    sens, prec = stats["sensitivity"]["species"], stats["precision"]["species"]
    if stats["total_reads"] != N_SIM_READS or sens < 75.0 or prec < 98.0:
        raise AssertionError(f"accuracy loop: {stats['total_reads']} reads, species sensitivity {sens}, "
                             f"precision {prec}")
    if loop["load_steps_s"].get("cache") != "hit" or "build" in loop["load_steps_s"] or \
            loop["table_digest"] != cold_digest:
        raise AssertionError(f"the accuracy loop's load did not take step 6b's table as it was built: "
                             f"{loop['load_steps_s']}")
    log(f"accuracy loop: {N_SIM_READS} reads in {loop['loop_s']:.1f}s, species sensitivity {sens:.3f}%, precision "
        f"{prec:.3f}%, {N_SIM_READS / loop['classify_s']:.0f} reads/s; a warm load of step 6b's table")
    with open(uid_out) as f, open(loop["files"]["kraken"]) as g:
        uid_calls = [line.split("\t")[2] for line in f]
        lca_calls = [line.split("\t")[2] for line in g]
    if uid_calls != lca_calls:
        raise AssertionError(f"UID database: {sum(a != b for a, b in zip(uid_calls, lca_calls))} of "
                             f"{len(uid_calls)} calls differ from the LCA database's")
    log(f"UID database: {len(uid_calls)} calls equal to the LCA database's, {uid_run_s:.1f}s after a "
        f"{uid_load_s:.1f}s load")

    if tools is not None:
        t = time.time()
        tools_out = _synth_result(tools, "the tools' process")
        log(f"waited {time.time() - t:.1f}s for the tools' process")
    else:
        tools_out = run_tools(os.path.dirname(run4["kraken"]), run4["kraken"], run4["report"], run4["reads"])
    tools_out["count-unique"] = {"s": cu_s, "rows": 1, "estimate": estimate, "distinct_kmers": n_fwd}

    rec = {
        "phase": "tools",
        "library_sequences": len(run4["genomes"]),
        "library_bp": sum(len(g) for g in run4["genomes"].values()),
        "keys": lca["key_ct"],
        "keys_shared": len(shared),
        "build_s": split,
        "lca_keys_per_s": lca["key_ct"] / split["lca_s"],
        "lca_rss_start_gb": rss[0] / 1e9,
        "lca_rss_peak_gb": rss[1] / 1e9,
        "build_memory_bytes": lca["memory_budget"],
        "step_6b": step_6b,
        "check_s": check_s,
        "phase4_reads": {
            "reads": N_READS, "run_s": run_s, "classify_s": classify_s, "reads_per_s": N_READS / run_s,
            "launches": launches, "max_memory_allocated_gb": peak / 1e9,
        },
        "accuracy": {
            "reads": N_SIM_READS, "read_len": 150, "error_rate": SIM_ERROR,
            **{key: loop[key] for key in ("loop_s", "simulate_s", "load_s", "waits_s", "load_steps_s", "classify_s",
                                          "grade_s", "launches")},
            "reads_per_s": N_SIM_READS / loop["classify_s"], "unidentified": stats["unidentified"],
            "sensitivity": stats["sensitivity"], "precision": stats["precision"],
        },
        "uid": {"load_s": uid_load_s, "run_s": uid_run_s, "reads_per_s": N_SIM_READS / uid_run_s,
                "launches": uid_launches},
        "tool_s": tools_out,
    }
    emit(rec)
    return rec, built_run


def phase_probe():
    """The probe tool's sweep through its entry point's function."""
    from krakenuniq_tpu_torch import _kernels
    from krakenuniq_tpu_torch.tools.probe_gather import sweep

    _kernels.reset_launches()
    recs = sweep(emit=lambda line: print(line, flush=True))
    launches = dict(_kernels.LAUNCHES)
    if launches["row_gather"] == 0:
        raise AssertionError("the probe sweep launched no row_gather kernel")
    best = max((r for r in recs if r["probe"] == "row_gather" and r["row_bytes"] == 16),
               key=lambda r: r["m_rows_per_s"])
    log(f"probe sweep: {len(recs)} settings, best 16 B rate {best['m_rows_per_s']:.0f} M rows/s at S={best['depth']}")
    return launches


# ------------------------------------------------------------------- driver


KERNELS = {
    "scores": ("krakenuniq_tpu_torch/csrc/scores.cu", "krakenuniq_tpu/taxonomy/resolve.py:67"),
    "kmer_front": ("krakenuniq_tpu_torch/csrc/kmer_front.cu", "krakenuniq_tpu/classify/device_step.py:154"),
    "chd_probe": ("krakenuniq_tpu_torch/csrc/chd_probe.cu", "krakenuniq_tpu/lookup/hash_lookup.py:104"),
    "chd_probe_acc": ("krakenuniq_tpu_torch/csrc/chd_probe.cu", "krakenuniq_tpu/classify/device_step.py:496"),
    "taxon_counts": ("krakenuniq_tpu_torch/csrc/taxon_counts.cu", "tools/counts_mxu_exp.py:35"),
    "hll_regmax": ("krakenuniq_tpu_torch/csrc/hll_regmax.cu", "krakenuniq_tpu/classify/device_counters.py:109"),
    "row_gather": ("krakenuniq_tpu_torch/csrc/row_gather.cu", "tools/probe_dma_exp.py:42"),
    "pack_runs": ("krakenuniq_tpu_torch/csrc/pack_runs.cu", "krakenuniq_tpu/classify/device_step.py:408"),
    "sparse_stats": ("krakenuniq_tpu_torch/csrc/sparse_stats.cu", "krakenuniq_tpu/classify/sparse_exact.py:79"),
    "sparse_keys": ("krakenuniq_tpu_torch/csrc/sparse_stats.cu", "krakenuniq_tpu/classify/sparse_exact.py:101"),
    "span_dict": ("krakenuniq_tpu_torch/csrc/span_dict.cu", "krakenuniq_tpu/classify/device_step.py:286"),
    "fused_probe": ("krakenuniq_tpu_torch/csrc/chd_probe.cu", "krakenuniq_tpu/lookup/hash_lookup.py:46"),
    "kmer_bins": ("krakenuniq_tpu_torch/csrc/kmer_front.cu", "krakenuniq_tpu/kmer/ops.py:87"),
    "bsearch_lookup": ("krakenuniq_tpu_torch/csrc/bsearch_lookup.cu", "krakenuniq_tpu/lookup/xla_lookup.py:35"),
    "bsearch_words": ("krakenuniq_tpu_torch/csrc/bsearch_lookup.cu", "krakenuniq_tpu/classify/device_step.py:157"),
    "rows_probe": ("krakenuniq_tpu_torch/csrc/chd_probe.cu", "krakenuniq_tpu/lookup/hash_lookup.py:78"),
    "rows_probe_acc": ("krakenuniq_tpu_torch/csrc/chd_probe.cu", "krakenuniq_tpu/classify/device_step.py:496"),
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--kernels-only", metavar="DIR",
                      help="run phases 1-2 only, on the krakenuniq_tpu_torch package under DIR")
    only.add_argument("--ooc-only", metavar="DIR",
                      help="measure the out-of-core chunk passes of the krakenuniq_tpu_torch package under "
                           "DIR on phase 4's database and reads (phase 1, then phase 8's passes)")
    only.add_argument("--uid-ooc-only", metavar="DIR",
                      help="measure the UID probes of the krakenuniq_tpu_torch package under DIR on phase 13's "
                           "database and reads: rows_probe on a span, then the raw chunk passes out of core")
    only.add_argument("--fallback-only", metavar="DIR",
                      help="measure the fallback lookups' kernels of the krakenuniq_tpu_torch package under "
                           "DIR on phase 4's database and reads (phase 1, then phases 9's and 10's spans)")
    args = ap.parse_args(argv)
    pkg_dir = args.kernels_only or args.ooc_only or args.fallback_only or args.uid_ooc_only
    if pkg_dir:
        sys.path.insert(0, os.path.abspath(pkg_dir))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from krakenuniq_tpu_torch import _kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    synth = None if pkg_dir else start_synthesis()
    t = time.time()
    paths = _kernels.build()
    log(f"kernels built in {time.time() - t:.1f}s: {sorted(paths)}")
    if not args.kernels_only:
        from krakenuniq_tpu_torch import _native_build

        t = time.time()
        so = _native_build.build()
        log(f"native host module built in {time.time() - t:.1f}s: {so}")
    if args.ooc_only:
        phase_ooc_compare(reps=20)
        print(card)
        return 0
    if args.fallback_only:
        phase_fallback_compare(reps=20)
        print(card)
        return 0
    if args.uid_ooc_only:
        phase_uid_ooc_compare(reps=20)
        print(card)
        return 0

    gather_rec, _, rows_acc_rec = phase_kernels(k=31)
    if args.kernels_only:
        print(card)
        return 0
    phase_goldens()
    uid_ooc_launches = phase_uid_goldens()
    fb_launches = phase_fallback_goldens()
    recs, launches, main_run = phase_main(reps=50, synth=synth)
    tools = start_tools(main_run)  # host only, beside phases 5-13
    sc_recs, sc_launches = phase_span_counters(main_run, reps=50)
    phase_counters(main_run, reps=20)
    phase_long_reads(main_run, reps=20)
    phase_exact(main_run)
    # the later phases load tables of their own: drop phase 4's, so that the
    # peak device memory each reports is its own
    del main_run["c"]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4's classifier released: {torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated")
    with shared_taxonomy():
        recs["rows_probe"], uid_launches = phase_uid(main_run, reps=20)
    _, built_run = phase_build(main_run, tools)
    # the fallbacks and out of core on the built database (phase 4's genome
    # keys), against its run of phase 4's reads
    with shared_taxonomy():
        recs["span_dict"], dict_launches = phase_dense_ids(built_run, reps=20)
        bs_recs, bs_launches = phase_bsearch(built_run, reps=20)
        fused_rec, fused_launches = phase_fused(built_run, reps=20)
        recs["chd_probe_acc"], ooc_launches = phase_ooc(built_run, reps=20)
    recs["rows_probe_acc"] = rows_acc_rec
    probe_launches = phase_probe()
    recs.update(sc_recs)
    recs.update(bs_recs)
    recs["row_gather"] = gather_rec
    recs["fused_probe"] = fused_rec
    # each kernel's launches come from the run of the path it serves: the
    # fused probe's from phase 10, the binary search's words entry's from
    # phase 9, the unpacked feed's bins and search from the goldens through
    # the bsearch fallback (their Python-route runs)
    launches = {**launches, **{k: sc_launches[k] for k in ("taxon_counts", "hll_regmax", "sparse_stats", "sparse_keys")},
                "span_dict": dict_launches["span_dict"], "chd_probe_acc": ooc_launches["chd_probe_acc"],
                "row_gather": probe_launches["row_gather"], "fused_probe": fused_launches["fused_probe"],
                "bsearch_words": bs_launches["bsearch_words"], "kmer_bins": fb_launches["bsearch"]["kmer_bins"],
                "bsearch_lookup": fb_launches["bsearch"]["bsearch_lookup"],
                # the raw probes' from phase 13's span run and the UID golden's
                # out-of-core run
                "rows_probe": uid_launches["rows_probe"], "rows_probe_acc": uid_ooc_launches["rows_probe_acc"]}

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = recs[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "device_ms_by": r["device_ms_by"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{key: r[key] for key in ("floor_ms", "floor_mix_ms") if key in r},
        })
    emit({"kernels": rows})
    print(card)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
