"""Time the candidate designs of seven kernels against the kept ones on the card.

`csrc/taxon_counts.cu`, `csrc/row_gather.cu`, `csrc/pack_runs.cu`,
`csrc/sparse_stats.cu`, `csrc/span_dict.cu` and the raw two-level probe
round of `csrc/chd_probe.cu` (`rows_probe`, `rows_probe_acc`) were each
chosen over other designs; `tools/variants/*.cu` keeps those candidates (each file includes
its kernel's source and adds them). This script builds them, runs every
candidate and the kept kernel (through its wrapper) on the same inputs,
holds each output equal to the plain PyTorch version, and prints one JSON
line per (case, design) with `device_ms`: the median card time of the
design's own kernels per call, from torch.profiler.

    python -m krakenuniq_tpu_torch.tools.kernel_variants [--reps 20] [--only rows_probe ...]
    python -m krakenuniq_tpu_torch.tools.kernel_variants --resources SRC...  # registers, spills

taxon_counts: grouping a warp's equal ids before the atomics (none, a
ballot on one id, __match_any_sync) in the shared and in the global form,
and a flush through 8-block clusters, on one work unit's two counts over
503, 58,112, 58,113 and 2,400,503 ids and at counts_mxu_exp's shape.
row_gather: a ring of registers, blocks sized from S on a persistent grid,
and cp.async.bulk copies, at 8,519,680 and 532,480 16-byte rows and
8,519,680 512-byte rows of a 1 GiB table. pack_runs: one warp per read
with plain loads (the first design), its ballot walk on the kept ring of
staged tiles, a thread per read on that ring, and the kept kernel with
plain loads and other tile sizes and ring depths, at [65536, 130] and
[4096, 130] in the compact layout. sparse_stats: the kept tile bodies on
a persistent grid that copies the next tile's keys while it works on the
current one, after the kept key build and torch.sort, on a span's
[65536, 130] (17 units) and a unit's [4096, 160] counted lanes (their
`device_ms` counts the kernels after the sort). span_dict: marking by
__match_any_sync (the first design), behind a block's table of ids (a lane
a thread, a first sighting reading its word from the L2 or not), and the
remap without evict-first hints, on a span's [65536, 130] zipf-1.3 ids
over 400, 3,000 and 40,000 of 2,400,503 ids and over the top 400 with 0
(`device_ms` counts the three kernels, not the memset every form runs).
rows_probe: the kept round (the confirm row after the round that
screened it, b2's tag row only where b1 does not screen), the speculative
confirm pair (b1's tag row and both its confirm rows side by side) and the
first design's round (both tag rows, then the confirm row), at kQ 4 and 8
and 1, 4, 6 and 8 blocks an SM, on 8,500,000 queries over random planes of
lb = 27 (3.2 GB), ~1% invalid, half planted (half of those in their second
bucket); rows_probe_acc: the same forms at kQ 4 and 8 (the pass keeps its
launch bounds), on a random raw chunk of lb = 23 at the span shape [65536,
160] and at [4096, 160], half the words set and half the searched lanes
planted. Each row carries its kernel's `registers`,
`spill_stores` and `spill_loads` from the variants build's `-Xptxas -v`
report. It needs a card and exits with 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _kernels
from ..classify import device_counters as dc
from ..classify import device_step as ds
from ..classify import sparse_exact as se
from . import probe_gather as pg

VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "variants")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    # variant, then kuniq_taxon_counts' arguments
    "taxon_counts": ("kuniq_taxon_counts_variant", (_I, _P, _P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _P)),
    # table, q, out, n, n_rows, row_words, depth, form, threads, stream
    "row_gather": ("kuniq_row_gather_variant", (_P, _P, _P, _L, _L, _I, _I, _I, _I, _P)),
    # form, tile, stages, ids, kmer_ambig, n_kmers, call, hits, map, n_map,
    # out, B, W, R, layout, row words, stream
    "pack_runs": ("kuniq_pack_runs_variant",
                  (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P)),
    # form, then kuniq_sparse_stats' arguments
    "sparse_stats": ("kuniq_sparse_stats_variant", (_I, _P, _P, _L, _I, _P, _L, _P, _P, _P, _P)),
    # form, then kuniq_span_dict's arguments
    "span_dict": ("kuniq_span_dict_variant", (_I, _P, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P)),
    # form, kQ, minimum blocks, then kuniq_rows_probe's arguments
    "rows_probe": ("kuniq_rows_probe_variant", (_I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _P)),
}
# further entry points of a variants library: name -> (library, symbol,
# argtypes); form, kQ, minimum blocks, then kuniq_rows_probe_acc's arguments
MORE_ENTRIES = {
    "rows_probe_acc": ("rows_probe", "kuniq_rows_probe_acc_variant",
                       (_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_ulonglong,
                        ctypes.c_ulonglong, _I, _P)),
}
# the raw probe's points: (form, kQ, minimum blocks); form 0 is the kept
# round, 1 the speculative confirm pair, 2 the first design's round
ROWS_FORMS = {0: "kept round", 1: "speculative confirm pair", 2: "both tag rows"}
ROWS_POINTS = [(f, q, m) for f in (0, 1) for q in (4, 8) for m in (1, 4, 6, 8)] + [(2, 4, 1)]
# the out-of-core pass keeps the CHD pass's launch bounds: only kQ varies
ACC_POINTS = [(0, 4, 1), (0, 8, 1), (1, 4, 1), (1, 8, 1), (2, 4, 1)]
SMEM_OPT_IN = 232_448  # bytes of shared memory one block may opt into on sm_90
CLUSTER = 8  # blocks per cluster of the cluster flush


def _variants_lib(name: str) -> str:
    """The library of tools/variants/<name>_variants.cu, named by a digest
    of it, of every csrc/ source (the variants include their kernel's) and
    of the flags."""
    h = hashlib.sha256(" ".join(_kernels.NVCC_FLAGS).encode())
    for path in [os.path.join(VARIANTS, f"{name}_variants.cu")] + sorted(
            os.path.join(_kernels.CSRC, f) for f in os.listdir(_kernels.CSRC)):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_kernels.BUILD_DIR, f"lib{name}_variants_{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named variants sources (all by default; one nvcc each, in
    parallel) next to the kernels' libraries, unless built already (ptxas'
    report kept beside each library); returns name -> the loaded entry
    point."""
    nvcc = _kernels._nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    libs, procs = {}, {}
    for name in names or ENTRIES:
        src = os.path.join(VARIANTS, f"{name}_variants.cu")
        libs[name] = lib = _variants_lib(name)
        if not os.path.exists(lib):
            cmd = [nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", _kernels.CSRC, "-o", f"{lib}.tmp", src]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    failed = []
    for name, proc in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}_variants.cu:\n{out}")
            continue
        with open(libs[name] + ".ptxas.txt", "w") as f:
            f.write(out)
        os.replace(f"{libs[name]}.tmp", libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    fns = {name: _bind(ctypes.CDLL(lib), *ENTRIES[name]) for name, lib in libs.items()}
    for name, (lib_name, symbol, argtypes) in MORE_ENTRIES.items():
        if lib_name in libs:
            fns[name] = _bind(ctypes.CDLL(libs[lib_name]), symbol, argtypes)
    return fns


@functools.lru_cache(maxsize=None)
def variants_usage(name: str) -> dict:
    """ptxas_usage of the variants library `name` as built (its kept
    report)."""
    with open(_variants_lib(name) + ".ptxas.txt") as f:
        return ptxas_usage(f.read())


def _demangle(names: list[str]) -> list[str]:
    """C++ names through the toolkit's cu++filt (or c++filt); the mangled
    names where neither runs."""
    try:
        tools = [os.path.join(os.path.dirname(_kernels._nvcc()), "cu++filt"), "c++filt"]
    except RuntimeError:  # no toolkit
        tools = ["c++filt"]
    for exe in tools:
        try:
            out = subprocess.run([exe], input="\n".join(names), capture_output=True, text=True, check=True).stdout
            return out.splitlines()[:len(names)]
        except (OSError, subprocess.CalledProcessError):
            continue
    return names


def ptxas_usage(text: str) -> dict:
    """Each kernel's registers and spill bytes from `nvcc -Xptxas -v`
    output: {kernel (demangled): {"registers", "spill_stores",
    "spill_loads", "stack"}}."""
    import re

    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    keys = list(usage)
    return dict(zip(_demangle(keys), (usage[k] for k in keys)))


def resources(sources) -> list[dict]:
    """Registers and spills of every kernel of each CUDA source (compiled
    to a cubin for sm_90a with -Xptxas -v, its own directory on the include
    path): one record per (source, kernel)."""
    nvcc = _kernels._nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    recs = []
    for src in sources:
        src = os.path.abspath(src)
        out = os.path.join(_kernels.BUILD_DIR, f"resources_{os.getpid()}.cubin")
        flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-I", os.path.dirname(src), "-o", out, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.remove(out)
        for kernel, use in ptxas_usage(proc.stdout + proc.stderr).items():
            recs.append({"source": src, "kernel": kernel, **use})
    return recs


def _bind(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def call(fn, *args) -> None:
    """One variant launch on the current stream; raises on a refused launch."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed with CUDA error {rc}")


def device_ms(fn, symbol: str, reps: int, per_call: int | None = None) -> float:
    """Median card milliseconds per call of fn() of the kernels whose name
    holds `symbol`, over `reps` calls under torch.profiler (with idle
    margins around the calls, wider when a session lost records). With
    `per_call` (the kernels a call launches), a session that still lost a
    record at its edge is read by that grouping."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for margin in (0.01, 0.25, 2.0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA" and symbol in e.name),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % reps == 0:
            per = len(evs) // reps
            break
    else:
        if per_call is None or len(evs) < per_call * (reps // 2):
            raise AssertionError(f"profiler saw {len(evs)} {symbol} kernels in {reps} calls")
        per = per_call
        evs = evs[len(evs) % per:]
    durs = [e.device_time_total for e in evs]
    return statistics.median(sum(durs[i:i + per]) for i in range(0, len(durs), per)) / 1e3


def counts_cases(seed: int = 12):
    """(label, [(ids, mask), ...], T): a work unit's two counts ([4096]
    reads, [4096, 130] k-mers, zipf-1.5 ids, 90% of lanes counted) over the
    503-id pool, over 58,112 and 58,113 ids and over the dense 2,400,503-id
    layout (the pool's ids scattered in it), 8,520,000 zipf ids over 504
    (counts_mxu_exp's shape) and 8,520,000 uniform ids over 2,400,503."""
    rng = np.random.default_rng(seed)
    cuda = lambda a: torch.from_numpy(a).cuda()
    dense = 2_400_503
    scattered = np.sort(rng.choice(dense, 503, replace=False))
    unit = lambda id_of, mod: [
        (cuda(id_of[rng.zipf(1.5, size=shape) % mod].astype(np.int32)), cuda(rng.random(shape) < 0.9))
        for shape in ((4096,), (4096, 130))]
    yield "unit pair", unit(np.arange(503), 503), 503
    for t in (58_112, 58_113):
        yield f"unit pair T={t}", unit(np.arange(t), t), t
    yield "dense zipf pair", unit(scattered, 503), dense
    n = 8_520_000
    yield "tool zipf", [(cuda((rng.zipf(1.5, size=n) % 504).astype(np.int32)), cuda(rng.random(n) < 0.9))], 504
    yield "uniform 2.4M", [(cuda(rng.integers(0, dense, size=n).astype(np.int32)), cuda(rng.random(n) < 0.9))], dense


def run_counts(fn, reps: int, emit) -> None:
    """Each taxon_counts design on each case: the kept kernel through its
    wrapper, the candidates of its form (shared or global, by counts_plan)
    on the same plan, the cluster flush on blocks rounded up to clusters."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, segs, t in counts_cases():
        n = [ids.numel() for ids, _ in segs] + [0]
        shared, blocks_a, blocks_b = dc.counts_plan(n[0], n[1], t, sms)
        zeros = lambda: [torch.zeros(t, dtype=torch.int64, device="cuda") for _ in segs]
        want = [dc.taxon_counts_plain(a, *seg) for a, seg in zip(zeros(), segs)]

        def kept():
            accs = zeros()
            if len(segs) == 1:
                return [dc.taxon_counts(accs[0], *segs[0])]
            return list(dc.taxon_counts_pair(accs[0], *segs[0], accs[1], *segs[1]))

        def variant(v, ba=blocks_a, bb=blocks_b):
            accs = zeros()
            (ia, ma), (ib, mb) = segs[0], (segs[1] if len(segs) > 1 else (None, None))
            call(fn, v, ia, ma, accs[0], n[0], ib, mb, accs[1] if len(segs) > 1 else None, n[1],
                 t, int(shared), ba, bb)
            return accs

        up = lambda b: -(-b // CLUSTER) * CLUSTER
        designs = [("kept", kept)]
        if shared:
            designs += [("shared ballot", lambda: variant(1)), ("shared match_any", lambda: variant(2)),
                        ("cluster flush", lambda: variant(3, up(blocks_a), up(blocks_b)))]
        else:
            designs += [("global ungrouped", lambda: variant(0)), ("global ballot", lambda: variant(1))]
        for design, run in designs:
            got = run()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"taxon_counts {label} {design}: differs from plain")
            emit({"kernel": "taxon_counts", "case": label, "t": t, "lanes": n[:len(segs)],
                  "form": "shared" if shared else "global", "design": design,
                  "device_ms": device_ms(run, "counts_", reps), "equal": True})


def threads_for(form: int, depth: int, row_bytes: int) -> int:
    """Block size of a row_gather candidate: 256 for the register ring; for
    the shared ring, as many warps (at most 32) as S slots of 16 + 4 bytes a
    thread fit in one block's shared memory; for bulk copies, as many warps
    as S slots of a row and an 8-byte mbarrier a warp fit."""
    if form == 0:
        return 256
    per_warp = depth * 32 * 20 if form == 1 else depth * (row_bytes + 8)
    return 32 * max(1, min(32, SMEM_OPT_IN // per_warp))


def run_gather(fn, reps: int, emit, seed: int = 7) -> None:
    """Each row_gather design at 8,519,680 16-byte rows (S = 1, 16, 256), one
    unit's 532,480 16-byte rows (S = 16) and 8,519,680 512-byte rows (S =
    16, 256) of a 1 GiB table: the kept kernel through its wrapper, the
    register ring (S <= 16), the shared ring in blocks sized from S on a
    persistent grid, and bulk copies (S >= 2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randint(-(1 << 31), 1 << 31, ((1 << 26) * 4,), dtype=torch.int32, device="cuda", generator=gen)
    for rb, n, depths in ((16, 8_519_680, (1, 16, 256)), (16, 4096 * 130, (16,)), (512, 8_519_680, (16, 256))):
        table = flat.view(-1, rb // 4)
        q = torch.randint(0, table.shape[0], (n,), dtype=torch.int32, device="cuda", generator=gen)
        want = pg.row_gather_plain(table, q)
        for s in depths:
            def variant(form, s=s, table=table, q=q):
                out = torch.empty((q.shape[0], table.shape[1]), dtype=torch.int32, device="cuda")
                call(fn, table, q, out, q.shape[0], table.shape[0], table.shape[1], s, form,
                     threads_for(form, s, rb))
                return out

            designs = [("kept", lambda s=s, table=table, q=q: pg.row_gather(table, q, s), 32)]
            if s <= 16:
                designs.append(("register ring", lambda: variant(0), threads_for(0, s, rb)))
            designs.append(("shared, blocks from S", lambda: variant(1), threads_for(1, s, rb)))
            if s >= 2:
                designs.append(("bulk copies", lambda: variant(2), threads_for(2, s, rb)))
            for design, run, threads in designs:
                if not torch.equal(run(), want):
                    raise AssertionError(f"row_gather {rb}B S={s} {design}: differs from index_select")
                ms = device_ms(run, "gather_", reps)
                emit({"kernel": "row_gather", "row_bytes": rb, "rows": n, "depth": s, "design": design,
                      "threads": threads, "device_ms": ms, "g_rows_per_s": n / ms / 1e6, "equal": True})
        del table, q, want


def rle_case(b: int, w: int, seed: int, k: int = 31):
    """One span's pack_runs inputs: runs of zipf-1.5 ids over 503 (lengths
    1-64), ~1% ambiguous lanes, a quarter of the reads with a fresh id at
    every lane (overflow rows), half the reads full (W k-mers), a tenth
    shorter than k, the rest between."""
    rng = np.random.default_rng(seed)
    run_len = rng.integers(1, 65, size=(64, w))
    starts = np.cumsum(run_len, axis=1) - run_len
    lane_run = np.resize(np.stack([np.searchsorted(s, np.arange(w), side="right") - 1 for s in starts]), (b, w))
    ids = np.take_along_axis((rng.zipf(1.5, size=(b, w)) % 503).astype(np.int32), lane_run, axis=1)
    noisy = rng.random(b) < 0.25
    ids[noisy] = rng.integers(0, 503, size=(int(noisy.sum()), w))
    amb = rng.random((b, w)) < 0.01
    lengths = rng.integers(0, w + k, size=b)
    lengths[: b // 2] = w + k - 1
    lengths[::10] = rng.integers(0, k, size=len(lengths[::10]))
    nk = np.maximum(lengths - (k - 1), 0).astype(np.int32)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    calls = rng.integers(0, 503, size=b).astype(np.int32)
    hits = rng.integers(0, w + 1, size=b).astype(np.int32)
    return cuda(ids), cuda(amb), cuda(nk), cuda(calls), cuda(hits)


def run_pack_runs(fn, reps: int, emit, r: int = 8) -> None:
    """Each pack_runs design on one span's and one unit's random planes in
    the compact layout: the kept kernel through its wrapper, one warp per
    read, the kept tile loop at other (tile, stages), stages 0 being plain
    loads, a thread per read on the staged tiles and the first design's
    ballot walk on the ring."""
    for b, w in ((65536, 130), (4096, 130)):
        ids, amb, nk, calls, hits = rle_case(b, w, b)
        want = ds.pack_runs_plain(ids, amb, nk, calls, hits, r, "compact")
        cols = ds.pack_runs_cols("compact", r)

        def variant(form, tile=16, stages=0):
            out = torch.empty((b, cols), dtype=torch.int32, device="cuda")
            call(fn, form, tile, stages, ids, amb, nk, calls, hits, None, 0, out, b, w, r, 0, cols)
            return out

        designs = [("kept", lambda: ds.pack_runs(ids, amb, nk, calls, hits, r, "compact")),
                   ("warp per read", lambda: variant(0))]
        designs += [(f"tile {t}, stages {s}", lambda t=t, s=s: variant(1, t, s))
                    for t, s in ((16, 0), (8, 3), (16, 2), (16, 4), (32, 3))]
        designs += [(f"thread per read, tile {t}, stages {s}", lambda t=t, s=s: variant(2, t, s))
                    for t, s in ((32, 2), (64, 2))]
        designs += [(f"ballot walk on the ring, tile {t}, stages {s}", lambda t=t, s=s: variant(3, t, s))
                    for t, s in ((16, 3), (32, 3))]
        for design, run in designs:
            if not torch.equal(run(), want):
                raise AssertionError(f"pack_runs [{b}, {w}] {design}: differs from plain")
            emit({"kernel": "pack_runs", "shape": [b, w], "layout": "compact", "design": design,
                  "device_ms": device_ms(run, "pack_runs", reps, per_call=1), "equal": True})


def stats_case(b: int, w: int, n_units: int, seed: int):
    """One update's sparse-stats planes: zipf-1.5 taxa over 503, random
    encodings on the five most frequent (they go dense), a few hundred on
    the rest (they stay sparse), ~90% counted lanes, rows in n_units
    consecutive work units."""
    rng = np.random.default_rng(seed)
    taxa = ((rng.zipf(1.5, size=(b, w)) - 1) % 503).astype(np.int32)
    enc = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    tail = taxa >= 5
    enc[tail] = (rng.integers(0, 300, size=int(tail.sum())).astype(np.uint32) << 7) | 3
    unit = np.repeat(np.arange(n_units), -(-b // n_units))[:b].astype(np.uint8)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return cuda(taxa), cuda(enc.view(np.int32)), cuda(rng.random((b, w)) < 0.9), cuda(unit)


def run_sparse_stats(fn, reps: int, emit, p: int = 12, cap: int = 1 << 21) -> None:
    """Each sparse_stats design after the kept key build (which clears the
    scratch's look-back state) and torch.sort, on a span's and a unit's
    planes."""
    for (b, w, units) in ((65536, 130, 17), (4096, 160, 1)):
        taxa, enc, lanes, unit = stats_case(b, w, units, b)
        want = se.sparse_stats_core(taxa, enc, lanes, unit, p, cap)
        n = b * w
        words = _kernels.entry("sparse_stats", "kuniq_sparse_stats_scratch", (_L,))(n)
        scratch = torch.empty(words, dtype=torch.int64, device="cuda")
        sk, ps = torch.sort(se.sparse_keys(taxa, enc, lanes, unit, scratch), stable=True)

        def variant(form):
            se.sparse_keys(taxa, enc, lanes, unit, scratch)
            buf = torch.empty(min(cap, n), dtype=torch.int64, device="cuda")
            counts = torch.empty(2, dtype=torch.int32, device="cuda")
            call(fn, form, sk, ps, n, (1 << p) // 4, buf, buf.numel(), counts[0], counts[1], scratch)
            return buf, counts[0], counts[1]

        for form, design in ((0, "kept"), (1, "pipelined, persistent")):
            if not all(torch.equal(g, x) for g, x in zip(variant(form), want)):
                raise AssertionError(f"sparse_stats [{b}, {w}] {design}: differs from plain")
            emit({"kernel": "sparse_stats", "shape": [b, w], "units": units, "design": design,
                  "device_ms": device_ms(lambda: variant(form), "sparse_stats_", reps), "equal": True})


def run_span_dict(fn, reps: int, emit, cap: int = 1 << 15, t: int = 2_400_503, seed: int = 21) -> None:
    """Each span_dict design on a span's ids, zipf-1.3 over 400, 3,000 and
    40,000 distinct ids scattered over the dense space, and over the 400
    ids at its top with 0 (a span's species cluster there, as chip_smoke's
    database lays them out), and its calls."""
    rng = np.random.default_rng(seed)
    words = _kernels.entry("span_dict", "kuniq_span_dict_scratch", (_I,))(t)
    scratch = torch.empty(words, dtype=torch.int32, device="cuda")
    for n_kinds, clustered in ((400, False), (3000, False), (40_000, False), (401, True)):
        if clustered:
            kinds = np.concatenate([[0], np.arange(t - n_kinds + 1, t)])
        else:
            kinds = np.unique(rng.choice(t, n_kinds, replace=False))
        ids = torch.from_numpy(kinds[(rng.zipf(1.3, size=(65536, 130)) - 1) % len(kinds)].astype(np.int32)).cuda()
        calls = torch.from_numpy(kinds[rng.integers(0, len(kinds), size=65536)].astype(np.int32)).cuda()
        want = ds.span_dict_plain(ids, calls, t, cap)

        def variant(form):
            lut = torch.empty(cap + 1, dtype=torch.int32, device="cuda")
            local, local_call = torch.empty_like(ids), torch.empty_like(calls)
            call(fn, form, ids, ids.numel(), calls, calls.numel(), t, cap, lut, local, local_call, scratch)
            return lut, local, local_call

        for form, design in ((0, "kept"), (1, "match_any marking"), (4, "a table of ids"),
                             (2, "a table of ids, marking without the read"), (3, "remap without evict-first")):
            if not all(torch.equal(g, x) for g, x in zip(variant(form), want)):
                raise AssertionError(f"span_dict {n_kinds} ids {design}: differs from plain")
            emit({"kernel": "span_dict", "shape": [65536, 130], "n_u": n_kinds, "clustered": clustered,
                  "design": design, "device_ms": device_ms(lambda: variant(form), "span_dict_", reps),
                  "equal": True})


def _point_usage(kernel: str, form: int, q: int, m: int, streamed: bool, lib: str = "rows_probe") -> dict:
    """registers and spill bytes of a raw probe point's kernel instance in
    the variants build (empty where ptxas' output named none)."""
    table = ("RawTable", "RawTableSpec", "RawTableBoth")[form] + f"<{q}, {m}>"
    flag = "true" if streamed else "false"
    for name, use in variants_usage(lib).items():
        plain = name.replace("(int)", "").replace("(bool)1", "true").replace("(bool)0", "false")
        if kernel in plain and f"::{table}, {flag}>" in plain:
            return {"registers": use.get("registers"), "spill_stores": use.get("spill_stores"),
                    "spill_loads": use.get("spill_loads")}
    return {}


def _streamed(lb: int) -> bool:
    """Whether the probe streams the confirm plane (16 B << lb) past the L2."""
    return (16 << lb) > torch.cuda.get_device_properties(0).L2_cache_size


def plant_raw(planes, h, seed: int):
    """Store the first half of `h` in slot 0 of its first-choice bucket and
    the rest in slot 1 of its second-choice bucket (the bucket's tag; the
    slot's confirm row: the low 32 hash bits and a random nonzero value),
    as the two-level build lays keys out."""
    from ..db.hash_table import GOLDEN
    from ..ints import lsr, s64, u32_to_i32

    ptags, confirm = planes
    lb = ptags.shape[0].bit_length() - 1
    gen = torch.Generator(device=h.device).manual_seed(seed)
    vals = u32_to_i32(torch.randint(1, 1 << 32, h.shape, dtype=torch.int64, device=h.device, generator=gen))
    half = h.numel() // 2
    for part, choice in ((slice(0, half), 0), (slice(half, None), 1)):
        hp = h[part]
        hc = hp * s64(int(GOLDEN)) if choice else hp
        bucket = lsr(hc, 64 - lb)
        ptags[bucket, choice] = u32_to_i32(lsr(hc << lb, 32))
        confirm[2 * bucket + choice, 0] = u32_to_i32(hp & 0xFFFFFFFF)
        confirm[2 * bucket + choice, 1] = vals[part]


def _random_i32(gen, *shape):
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device="cuda", generator=gen)


def rows_random_case(n: int = 8_500_000, lb: int = 27, seed: int = 79):
    """Random raw planes of width 2^lb, n random queries, ~1% invalid, half
    of them planted (plant_raw)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    planes = (_random_i32(gen, 1 << lb, 2), _random_i32(gen, 2 << lb, 2))
    h = (_random_i32(gen, n).long() << 32) | (_random_i32(gen, n).long() & 0xFFFFFFFF)
    valid = torch.rand(n, device="cuda", generator=gen) >= 0.01
    plant_raw(planes, h[: n // 2], seed + 10)
    return planes, h, valid


def run_rows(fn, reps: int, emit, label: str, planes, h, valid, points=None) -> None:
    """Each raw probe design on one case: the kept kernel through its
    wrapper, then every point (form, kQ, minimum blocks) of the variants."""
    from ..lookup.hash_lookup import hash_lookup_kmers, hash_lookup_plain

    lb = planes[0].shape[0].bit_length() - 1
    want = hash_lookup_plain(planes, h, valid)

    def variant(form, q, m):
        out = torch.empty(h.shape, dtype=torch.int32, device="cuda")
        call(fn, form, q, m, *planes, h, valid, out, h.numel(), lb)
        return out

    designs = [("kept", None, lambda: hash_lookup_kmers(planes, h, valid))]
    designs += [(ROWS_FORMS[f], (f, q, m), lambda p=(f, q, m): variant(*p)) for f, q, m in points or ROWS_POINTS]
    for design, point, run in designs:
        if not torch.equal(run(), want):
            raise AssertionError(f"rows_probe {label} {design} {point}: differs from plain")
        use = _point_usage("rows_probe_kernel", *point, _streamed(lb)) if point else {}
        emit({"kernel": "rows_probe", "case": label, "shape": list(h.shape), "lb": lb, "design": design,
              "kq": point and point[1], "min_blocks": point and point[2], **use,
              "device_ms": device_ms(run, "rows_probe_kernel", reps), "equal": True})


def run_rows_acc(fn, reps: int, emit, label: str, feed, planes, bounds, acc0, k: int, nt: int,
                 points=None) -> None:
    """Each raw out-of-core pass design on one case (a span's packed feed,
    a raw chunk table and its bin range, the word plane before the pass):
    the kept kernel through probe_chunk_core, then the variants' points."""
    codes, ambig, lengths = feed
    lb = planes[0].shape[0].bit_length() - 1
    b, w = acc0.shape
    lo, hi = (int(x) for x in bounds)
    want = ds.probe_chunk_core(acc0.clone(), planes, bounds, *feed, k, nt, plain=True)
    acc = torch.empty_like(acc0)

    def variant(form, q, m):
        acc.copy_(acc0)
        call(fn, form, q, m, codes, ambig, lengths, *planes, acc, b, 16 * codes.shape[1], w, k, nt, lo, hi, lb)
        return acc

    designs = [("kept", None, lambda: ds.probe_chunk_core(acc.copy_(acc0), planes, bounds, *feed, k, nt))]
    designs += [(ROWS_FORMS[f], (f, q, m), lambda p=(f, q, m): variant(*p)) for f, q, m in points or ACC_POINTS]
    for design, point, run in designs:
        if not torch.equal(run(), want):
            raise AssertionError(f"rows_probe_acc {label} {design} {point}: differs from plain")
        use = _point_usage("chd_probe_acc_kernel<unsigned int", *point, _streamed(lb)) if point else {}
        emit({"kernel": "rows_probe_acc", "case": label, "shape": [b, w], "lb": lb, "design": design,
              "kq": point and point[1], "min_blocks": point and point[2], **use,
              "device_ms": device_ms(run, "chd_probe_acc_kernel", reps), "equal": True})


def acc_random_case(b: int, lb_chunk: int = 23, seed: int = 97, k: int = 31, nt: int = 12):
    """A random raw chunk of width 2^lb_chunk and a span of b random reads
    of 160 bases (packed words, ~1% ambiguous bases, lengths 0 to 160), half
    the words set, half the searched lanes planted, the bin range the middle
    half of the searched lanes' bins: (feed, planes, bounds, acc0)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lbases = 160
    lengths = np.where(rng.random(b) < 0.8, lbases, rng.integers(0, lbases, size=b)).astype(np.int32)
    amb = (rng.random((b, lbases)) < 0.01) | (np.arange(lbases)[None, :] >= lengths[:, None])
    bases = np.where(amb, 0, rng.integers(0, 4, size=(b, lbases))).astype(np.uint8)
    codes, ambig = ds.pack_input(torch.from_numpy(bases).cuda(), torch.from_numpy(amb).cuda())
    lengths = torch.from_numpy(lengths).cuda()
    feed = (codes, ambig, lengths)
    hashes, _, kmer_ambig = ds.kmer_front_words(codes, ambig, k, 12)
    _, bins = ds.kmer_bins_words(codes, k, nt)
    w = lbases - k + 1
    in_read = torch.arange(w, device="cuda")[None, :] < (lengths - (k - 1)).clamp(min=0)[:, None]
    searched = in_read & ~kmer_ambig
    planes = (_random_i32(gen, 1 << lb_chunk, 2), _random_i32(gen, 2 << lb_chunk, 2))
    plant_raw(planes, hashes[searched & (torch.rand(searched.shape, device="cuda", generator=gen) < 0.5)], seed)
    sb = bins[searched].sort().values
    bounds = (int(sb[sb.numel() // 4]), int(sb[3 * sb.numel() // 4]))
    acc0 = torch.where(torch.rand((b, w), device="cuda", generator=gen) < 0.5,
                       torch.randint(1, 1 << 31, (b, w), dtype=torch.int32, device="cuda", generator=gen), 0)
    return feed, planes, bounds, acc0


def run_rows_random(fns, reps: int, emit) -> None:
    """The raw probe's designs on phase 2's random cases: rows_probe on
    8.5M queries at lb = 27, rows_probe_acc on a random lb = 23 chunk at
    [65536, 160] and [4096, 160]."""
    planes, h, valid = rows_random_case()
    run_rows(fns["rows_probe"], reps, emit, "random planes", planes, h, valid)
    del planes, h, valid
    torch.cuda.empty_cache()
    for b in (65536, 4096):
        feed, planes, bounds, acc0 = acc_random_case(b)
        run_rows_acc(fns["rows_probe_acc"], reps, emit, "random chunk", feed, planes, bounds, acc0, 31, 12)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=sorted(ENTRIES), action="append",
                    help="run only this kernel's designs (repeatable)")
    ap.add_argument("--resources", nargs="+", metavar="SRC",
                    help="print the registers and spills of every kernel of these CUDA sources and exit")
    args = ap.parse_args(argv)
    emit = lambda rec: print(json.dumps(rec), flush=True)
    if args.resources:
        for rec in resources(args.resources):
            emit(rec)
        return 0
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device available", file=sys.stderr)
        return 2
    names = args.only or list(ENTRIES)
    _kernels.build([n for n in names if n in _kernels.SIGNATURES] + ["chd_probe"] * ("rows_probe" in names))
    fns = build(names)
    runs = {
        "taxon_counts": lambda: run_counts(fns["taxon_counts"], args.reps, emit),
        "row_gather": lambda: run_gather(fns["row_gather"], max(5, args.reps // 2), emit),
        "pack_runs": lambda: run_pack_runs(fns["pack_runs"], args.reps, emit),
        "sparse_stats": lambda: run_sparse_stats(fns["sparse_stats"], args.reps, emit),
        "span_dict": lambda: run_span_dict(fns["span_dict"], args.reps, emit),
        "rows_probe": lambda: run_rows_random(fns, args.reps, emit),
    }
    for name in names:
        runs[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
