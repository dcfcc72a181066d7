"""The port's --device-counters path (krakenuniq_tpu_torch.classify.
device_counters) and its kernels' plain versions against the JAX package:
`update_core` in each of the JAX register layouts, `taxon_counts` against
the `counts_mxu` Pallas kernel and `row_gather` against the `make_probe`
Pallas kernel (both in interpret mode), and the Classifier and CLI with
device counters against the goldens and the JAX host counter."""

import functools
import importlib.util
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from krakenuniq_tpu.classify import Classifier as JClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JOptions
from krakenuniq_tpu.classify import device_counters as JD
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.classify import device_counters as TD
from krakenuniq_tpu_torch.classify import sparse_exact as TS
from krakenuniq_tpu_torch.cli.main import main as cli_main
from krakenuniq_tpu_torch.tools import probe_gather as PG
from krakenuniq_tpu_torch.utils.bits import decode_rank, encode_hash_32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _load_tool(name, monkeypatch):
    """Load tools/<name>.py by path; it parses sys.argv at import."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- update_core


def _encodings(rng, shape, p):
    """HLL encodings (uint32) of random hashes: a third flagged (the bits
    between the p and 25 index prefixes cleared), and hashes shifted right
    by random amounts for a spread of ranks."""
    h = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    gap = np.uint64(((1 << (25 - p)) - 1) << (64 - 25))
    h = np.where(rng.random(shape) < 0.33, h & ~gap, h)
    h = h >> rng.integers(0, 40, size=shape).astype(np.uint64)
    return encode_hash_32(h, p)


# name: (T ids, register pool ids or None for rows = ids, identity_pool,
# counts_only); "sort_segmax" and "lut" land in the JAX package's two
# non-identity branches (P*m <= 2^22 and above)
LAYOUTS = {
    "identity": (60, None, True, False),
    "sort_segmax": (300, 40, False, False),
    "lut": (5000, 1100, False, False),
    "counts_only": (60, None, True, True),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_update_core_matches_jax(layout):
    t, n_pool, identity, counts_only = LAYOUTS[layout]
    p, b, w = 12, 24, 50
    m = 1 << p
    rng = np.random.default_rng(sorted(LAYOUTS).index(layout))
    if n_pool is None:
        pool = np.arange(t)
    else:
        pool = np.unique(np.concatenate([[0], rng.choice(np.arange(1, t), n_pool - 1, replace=False)]))
    if counts_only:
        pool = np.zeros(1, np.int64)
    lut = np.zeros(t, np.int32)
    lut[pool] = np.arange(len(pool), dtype=np.int32)
    taxa = pool[rng.integers(0, len(pool), size=(b, w))].astype(np.int32)
    enc = _encodings(rng, (b, w), p)
    lanes = rng.random((b, w)) < 0.8
    call = rng.integers(0, t, size=b).astype(np.int32)
    row_valid = rng.random(b) < 0.9
    reg0 = rng.integers(0, 6, size=(len(pool), m), dtype=np.uint8)
    kc0 = rng.integers(0, 100, size=t).astype(np.int64)
    rc0 = rng.integers(0, 100, size=t).astype(np.int64)
    unit_id = np.repeat(np.arange(2, dtype=np.uint8), b // 2)
    cap = 0 if counts_only else 4096

    want = JD.update_core(
        jnp.asarray(reg0), jnp.asarray(kc0), jnp.asarray(rc0),
        (jnp.asarray(pool.astype(np.int32)), jnp.asarray(lut)),
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(call),
        jnp.asarray(row_valid), p, jnp.asarray(unit_id), cap, counts_only, identity,
    )
    got = TD.update_core(
        torch.from_numpy(reg0.copy()), torch.from_numpy(kc0.copy()), torch.from_numpy(rc0.copy()),
        None if identity else torch.from_numpy(lut),
        torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)), torch.from_numpy(lanes),
        torch.from_numpy(call), torch.from_numpy(row_valid), p,
        torch.from_numpy(unit_id.astype(np.int64)), cap, counts_only,
    )
    assert len(got) == len(want) == (3 if counts_only else 6)
    names = ("registers", "kmer_counts", "read_counts", "sparse buf", "n_pairs", "n_events")
    for name, g, w_ in zip(names, got, want):
        g = g.numpy()
        if name == "sparse buf":
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, np.asarray(w_), err_msg=f"{layout}: {name}")
    if not counts_only:
        assert (got[0].numpy() > reg0).any(), "the update should raise some registers"


# hll_regmax's edge cases, each run in the JAX update_core's register branches
REGMAX_EDGES = ["hot_slot", "hot_row", "prefilled", "p4", "p18", "flag_values"]


def _edge_layout(layout, p):
    """(T ids, register pool size or None for rows = ids): each lands in its
    JAX branch (sort_segmax needs P*m <= 2^22, lut P*m > 2^22)."""
    m = 1 << p
    return {
        "identity": (60, None),
        "sort_segmax": (300, min(40, (1 << 22) // m)),
        "lut": (max(5000, (1 << 22) // m + 1000), (1 << 22) // m + 100),
    }[layout]


def _edge_inputs(case, rng, n_rows, p, shape=(24, 50)):
    """(register rows per lane, enc, lanes, reg0) for one hll_regmax edge
    case; rows index the register pool."""
    m = 1 << p
    rows = rng.integers(0, n_rows, size=shape)
    enc = _encodings(rng, shape, p)
    lanes = rng.random(shape) < 0.8
    reg0 = np.zeros((n_rows, m), np.uint8)
    if case in ("hot_slot", "hot_row"):
        rows[:] = n_rows // 2
    if case == "hot_slot":
        enc[:] = enc.reshape(-1)[0]
    if case == "prefilled":
        reg0 = rng.integers(0, 41, size=(n_rows, m), dtype=np.uint8)
    if case == "flag_values":
        stored = (np.arange(enc.size, dtype=np.uint32) % 64).reshape(shape)
        enc = (rng.integers(0, 1 << 25, size=shape, dtype=np.uint32) << np.uint32(7)) | (stored << np.uint32(1)) | 1
    return rows, enc, lanes, reg0


@pytest.mark.parametrize("case,layout", [
    (c, lay) for c in REGMAX_EDGES for lay in ("identity", "sort_segmax", "lut")
    if not (c == "flag_values" and lay == "sort_segmax")
])
def test_update_core_registers_edge_cases_match_jax(case, layout):
    """update_core's register plane through the plain hll_regmax (plain=True)
    against the JAX update_core on hll_regmax's edge cases: one hot slot,
    one hot row, pre-filled registers, p = 4 and 18, and flagged encodings
    with every stored value 0-63. The JAX sort_segmax branch packs the rank
    in 6 bits of its sort key, which holds every rank a real encoding gives
    (stored values <= 40) but not the ranks >= 64 of stored values past
    63 - (25 - p), so flag_values runs only in the two scatter branches."""
    p = {"p4": 4, "p18": 18}.get(case, 12)
    t, n_pool = _edge_layout(layout, p)
    rng = np.random.default_rng(REGMAX_EDGES.index(case) * 3 + ["identity", "sort_segmax", "lut"].index(layout))
    identity = n_pool is None
    pool = np.arange(t) if identity else np.unique(
        np.concatenate([[0], rng.choice(np.arange(1, t), n_pool - 1, replace=False)]))
    lut = np.zeros(t, np.int32)
    lut[pool] = np.arange(len(pool), dtype=np.int32)
    rows, enc, lanes, reg0 = _edge_inputs(case, rng, len(pool), p)
    taxa = pool[rows].astype(np.int32)
    b = taxa.shape[0]
    zeros_t = np.zeros(t, np.int64)
    call = np.zeros(b, np.int32)
    row_valid = np.ones(b, bool)

    want = JD.update_core(
        jnp.asarray(reg0), jnp.asarray(zeros_t), jnp.asarray(zeros_t),
        (jnp.asarray(pool.astype(np.int32)), jnp.asarray(lut)),
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(call),
        jnp.asarray(row_valid), p, None, 0, False, identity,
    )
    got = TD.update_core(
        torch.from_numpy(reg0.copy()), torch.from_numpy(zeros_t.copy()), torch.from_numpy(zeros_t.copy()),
        None if identity else torch.from_numpy(lut),
        torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)), torch.from_numpy(lanes),
        torch.from_numpy(call), torch.from_numpy(row_valid), p, plain=True,
    )
    for name, g, w_ in zip(("registers", "kmer_counts", "read_counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=f"{case}/{layout}: {name}")
    assert (got[0].numpy() > reg0).any(), "the update should raise some registers"


# the counts of one work unit on update_core's one-launch path: name ->
# (T ids, rows B, how the unit's ids and masks are drawn)
COUNT_CASES = {
    "no_reads": (60, 24, "reads masked"),
    "all_masked": (60, 24, "all masked"),
    "edge_ids": (60, 24, "ids 0 and T-1"),
    "t1": (1, 24, "ids 0"),
    "empty": (60, 0, ""),
}


def _count_inputs(case, layout, rng, w=50):
    """(T, pool, lut, taxa, enc, lanes, call, row_valid) for one case: the
    pool layout (register rows are ids) or the dense layout (the pool's
    values scattered over T ids, rows through a lut)."""
    t, b, draw = COUNT_CASES[case]
    if layout == "dense_lut":
        t = t * 1000 if t > 1 else 1
    pool = np.arange(t) if layout == "pool" else np.unique(
        np.concatenate([[0, t - 1], rng.choice(t, min(t, 40), replace=False)]))
    lut = np.zeros(t, np.int32)
    lut[pool] = np.arange(len(pool), dtype=np.int32)
    taxa = pool[rng.integers(0, len(pool), size=(b, w))].astype(np.int32)
    call = pool[rng.integers(0, len(pool), size=b)].astype(np.int32)
    if draw == "ids 0 and T-1":
        taxa = np.where(rng.random((b, w)) < 0.5, 0, t - 1).astype(np.int32)
        call = np.where(rng.random(b) < 0.5, 0, t - 1).astype(np.int32)
    lanes = rng.random((b, w)) < 0.8
    row_valid = rng.random(b) < 0.9
    if draw in ("reads masked", "all masked"):
        row_valid[:] = False
    if draw == "all masked":
        lanes[:] = False
    return t, pool, lut, taxa, _encodings(rng, (b, w), 12), lanes, call, row_valid


@pytest.mark.parametrize("case,layout", [(c, lay) for c in COUNT_CASES for lay in ("pool", "dense_lut")])
def test_update_core_counts_pair_matches_jax(case, layout):
    """update_core's counts, one taxon_counts_pair call per unit (on the CPU
    its two plain calls), against the JAX update_core's read_counts and
    kmer_counts and against two taxon_counts_plain calls, on a unit with its
    reads masked off, all lanes masked off, only ids 0 and T-1, T = 1, and
    no rows; registers too, but for the unit of no rows."""
    p = 12
    rng = np.random.default_rng(sorted(COUNT_CASES).index(case) * 2 + (layout == "pool"))
    t, pool, lut, taxa, enc, lanes, call, row_valid = _count_inputs(case, layout, rng)
    identity = layout == "pool"
    counts_only = case == "empty"  # the JAX register branches take no empty unit
    reg0 = np.zeros((len(pool), 1 << p), np.uint8)
    kc0 = rng.integers(0, 100, size=t).astype(np.int64)
    rc0 = rng.integers(0, 100, size=t).astype(np.int64)
    want = JD.update_core(
        jnp.asarray(reg0), jnp.asarray(kc0), jnp.asarray(rc0),
        (jnp.asarray(pool.astype(np.int32)), jnp.asarray(lut)),
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(call),
        jnp.asarray(row_valid), p, None, 0, counts_only, identity,
    )
    got = TD.update_core(
        torch.from_numpy(reg0.copy()), torch.from_numpy(kc0.copy()), torch.from_numpy(rc0.copy()),
        None if identity else torch.from_numpy(lut),
        torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)), torch.from_numpy(lanes),
        torch.from_numpy(call), torch.from_numpy(row_valid), p, counts_only=counts_only,
    )
    for name, g, w_ in zip(("registers", "kmer_counts", "read_counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=f"{case}/{layout}: {name}")
    kc, rc = torch.from_numpy(kc0.copy()), torch.from_numpy(rc0.copy())
    TD.taxon_counts_plain(rc, torch.from_numpy(call), torch.from_numpy(row_valid))
    TD.taxon_counts_plain(kc, torch.from_numpy(taxa), torch.from_numpy(lanes))
    assert torch.equal(got[1], kc) and torch.equal(got[2], rc)


@pytest.mark.parametrize("n_a,n_b,t,want", [
    # one unit in the pool layout: 4,096 reads and 4,096 x 130 k-mers over 503 ids
    (4096, 532_480, 503, (True, 2, 132)),
    # counts_mxu_exp's shape: ~8 T lanes a block would be 2,113 blocks; one wave is 528
    (0, 8_520_000, 504, (True, 0, 528)),
    # the largest T the shared histogram holds, and one past it
    (1000, 532_480, 58_112, (True, 1, 132)),
    (1000, 532_480, 58_113, (False, 1, 260)),
    # the dense layout: global atomics, a block per 2,048 lanes, one wave at most
    (4096, 532_480, 2_400_503, (False, 2, 260)),
    (0, 8_520_000, 2_400_503, (False, 0, 528)),
    (0, 0, 503, (True, 0, 0)),
])
def test_counts_plan(n_a, n_b, t, want):
    """The taxon_counts launch plan: form by T, blocks per segment (at most
    one wave, ~8 T lanes a block in the shared form), no block for an
    empty segment."""
    assert TD.counts_plan(n_a, n_b, t, 132) == want


@pytest.mark.parametrize("depth,loads,want", [
    (1, None, 16), (16, None, 16), (32, None, 32), (64, None, 64), (256, None, 256), (16, 256, 256),
])
def test_gather_plan(depth, loads, want):
    """row_gather's copies per lane: max(16, S), so that a lane's ring of S
    copies fills, unless the caller names them."""
    assert PG.copies_per_lane(depth, loads) == want
    assert depth in PG.DEPTHS


@pytest.mark.parametrize("form,depth,row_bytes,want", [
    (0, 16, 16, 256), (1, 1, 16, 1024), (1, 16, 16, 704), (1, 256, 16, 32),
    (2, 16, 16, 1024), (2, 16, 512, 864), (2, 256, 512, 32),
])
def test_kernel_variants_block_size(form, depth, row_bytes, want):
    """The row_gather candidates' blocks: 256 threads for the register ring;
    for the shared ring and bulk copies as many warps as their S slots fit
    in one block's 227 KB of shared memory, at least one and at most 32."""
    from krakenuniq_tpu_torch.tools import kernel_variants as KV

    threads = KV.threads_for(form, depth, row_bytes)
    assert threads == want
    per_thread = {0: 0, 1: depth * 20, 2: depth * (row_bytes + 8) / 32}[form]
    assert threads * per_thread <= KV.SMEM_OPT_IN


def test_device_counters_default_to_the_card():
    """DeviceCounters keeps its state on the card unless asked for the CPU;
    the Classifier passes its own device."""
    import inspect

    assert inspect.signature(TD.DeviceCounters.__init__).parameters["device"].default == "cuda"
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", device_counters=True))
    dc = c.dev_counters
    assert {dc.reg.device.type, dc.kmer_counts.device.type, dc.read_counts.device.type} == {"cpu"}


def test_hll_ranks_match_decode_rank():
    rng = np.random.default_rng(5)
    for p in (4, 12, 14, 18):
        enc = _encodings(rng, (4000,), p)
        enc[:3] = [0, 1, 0xFFFFFFFF]
        assert 0 < int((enc & 1).sum()) < len(enc), "flagged and plain encodings"
        idx, rank = TD.hll_ranks(torch.from_numpy(enc.view(np.int32)), p)
        np.testing.assert_array_equal(idx.numpy(), enc >> np.uint32(32 - p))
        np.testing.assert_array_equal(rank.numpy(), decode_rank(enc, p))


# ------------------------------------------------------------ Pallas tools


@pytest.mark.parametrize("n,t", [(5000, 504), (4100, 130), (4100, 13_000)])
def test_taxon_counts_plain_matches_counts_mxu(n, t, monkeypatch):
    tool = _load_tool("counts_mxu_exp", monkeypatch)
    rng = np.random.default_rng(n)
    x = (rng.zipf(1.5, size=n) % t).astype(np.int32)
    want = np.asarray(tool.counts_mxu(jnp.asarray(x), t, interpret=True))
    mask = torch.ones(n, dtype=torch.bool)
    acc = torch.zeros(t, dtype=torch.int64)
    np.testing.assert_array_equal(TD.taxon_counts(acc, torch.from_numpy(x), mask).numpy(), want)
    # the mask drops lanes exactly as the pipeline's out-of-range id does
    keep = rng.random(n) < 0.7
    want_m = np.asarray(tool.counts_mxu(jnp.asarray(np.where(keep, x, t)), t, interpret=True))
    got_m = TD.taxon_counts(torch.zeros(t, dtype=torch.int64), torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_array_equal(got_m.numpy(), want_m)


class _InterpretPallas:
    """`pl` with pallas_call in interpret mode (the tool has no flag)."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.mark.parametrize("q_block,depth", [(64, 8), (64, 1), (64, 2), (64, 16)])
def test_row_gather_plain_matches_make_probe(q_block, depth, monkeypatch):
    tool = _load_tool("probe_dma_exp", monkeypatch)
    monkeypatch.setattr(tool, "pl", _InterpretPallas())
    rng = np.random.default_rng(depth)
    n_chunks, rows = 3, 256
    table = rng.integers(0, 1 << 32, size=(rows, 128), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, rows, size=n_chunks * q_block).astype(np.int32)
    probe = tool.make_probe(q_block, depth, n_chunks)
    want = np.asarray(probe(jnp.asarray(q.reshape(n_chunks, 8, q_block // 8)), jnp.asarray(table)))
    got = PG.row_gather(torch.from_numpy(table.view(np.int32)), torch.from_numpy(q), depth)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, table[q])


def test_row_gather_16_byte_rows():
    """The CHD row size, which the TPU tool could not compile."""
    rng = np.random.default_rng(1)
    table = rng.integers(-(1 << 31), 1 << 31, size=(1000, 4)).astype(np.int32)
    q = rng.integers(0, 1000, size=777).astype(np.int32)
    got = PG.row_gather(torch.from_numpy(table), torch.from_numpy(q), 16)
    np.testing.assert_array_equal(got.numpy(), table[q])


# -------------------------------------------------------------- Classifier


@pytest.fixture(scope="module")
def jax_host():
    """The JAX package's host-counter run on the golden reads."""
    c = JClassifier([DATA], JOptions(print_progress=False))
    kraken = io.StringIO()
    c.run([READS], kraken_fh=kraken)
    return c, kraken.getvalue()


def _port(**opts):
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([READS], kraken_fh=kraken)
    c.write_report(report)
    return c, kraken.getvalue(), report.getvalue()


@pytest.mark.parametrize("case", ["fasta", "fastq", "hierarchical"])
def test_device_counters_match_golden(case):
    reads, dbs, goldens = {
        "fasta": ("reads.fa", ".", ("kraken.out", "report.tsv")),
        "fastq": ("reads.fq", ".", ("kraken_fq.out", "report_fq.tsv")),
        "hierarchical": ("reads.fa", "db_bact db_viral", ("kraken_hier.out", "report_hier.tsv")),
    }[case]
    c = Classifier(
        [os.path.join(DATA, d) for d in dbs.split()],
        ClassifyOptions(print_progress=False, device="cpu", device_counters=True),
    )
    kraken, report = io.StringIO(), io.StringIO()
    c.run([os.path.join(DATA, reads)], kraken_fh=kraken)
    c.write_report(report)
    assert c.dev_counters.tracker.overflows == 0
    assert kraken.getvalue() == _golden(goldens[0])
    assert report.getvalue() == _golden(goldens[1])


def test_device_counters_state_matches_jax_host_counter(jax_host):
    """Per-taxon HLL state -- mode, sparse set or registers, n_observed --
    and both counters equal the JAX host fold's."""
    jc, jkraken = jax_host
    c, kraken, _ = _port(device_counters=True)
    assert kraken == jkraken
    host = jc.counter.counts
    dev = c.dev_counters.finalize(c._taxids_host)
    assert set(host) == set(dev)
    saw_sparse = saw_dense = False
    for taxid, h_rc in host.items():
        d_rc = dev[taxid]
        assert (h_rc.n_reads, h_rc.n_kmers) == (d_rc.n_reads, d_rc.n_kmers), taxid
        h, d = h_rc.kmers, d_rc.kmers
        if h is None or h.n_observed == 0:
            assert d.n_observed == 0
            continue
        assert (h.n_observed, h.sparse) == (d.n_observed, d.sparse), taxid
        if h.sparse:
            saw_sparse = True
            np.testing.assert_array_equal(np.sort(h.sparse_set), np.sort(d.sparse_set))
        else:
            saw_dense = True
            np.testing.assert_array_equal(h.M, d.M, err_msg=str(taxid))
    assert saw_sparse, "the fixture should exercise sparse-regime taxa"
    del saw_dense


def test_device_counters_approx_mode(jax_host):
    """sparse_cap=0: no sparse tracking; registers equal a dense-converted
    JAX host HLL (estimate-level compat)."""
    jc, jkraken = jax_host
    c, kraken, _ = _port(device_counters=True, sparse_cap=0)
    assert kraken == jkraken and c.dev_counters.tracker is None
    host = jc.counter.counts
    dev = c.dev_counters.finalize(c._taxids_host)
    assert set(host) == set(dev)
    for taxid, h_rc in host.items():
        assert (h_rc.n_reads, h_rc.n_kmers) == (dev[taxid].n_reads, dev[taxid].n_kmers)
        h = h_rc.kmers
        if h is None or h.n_observed == 0:
            assert dev[taxid].kmers.n_observed == 0
            continue
        hd = h.copy()
        if hd.sparse:
            hd.sparse = False
            hd.M = np.zeros(hd.m, np.uint8)
            if len(hd.sparse_set):
                hd._registers_max(hd.sparse_set)
        np.testing.assert_array_equal(hd.M, dev[taxid].kmers.M, err_msg=str(taxid))


@pytest.mark.parametrize("use_native", [True, False], ids=["span", "python"])
def test_device_counters_overflow_mode(use_native):
    """A 4-slot sparse buffer overflows on every update (a span on the span
    route, a work unit on the Python route): its stats are redone on the
    host, the overflow is counted and the report stays byte-equal."""
    c, kraken, report = _port(device_counters=True, sparse_cap=4, use_native=use_native)
    assert c.dev_counters.tracker.overflows == (c.n_spans if use_native else c.n_units) > 0
    assert kraken == _golden("kraken.out")
    assert report == _golden("report.tsv")


def test_device_counters_host_stats_mode(monkeypatch):
    """Id spaces past the device packing (2^TAXON_BITS) compute the sparse
    stats on the host, still bit-exact; forced by shrinking the packing
    below the fixture's taxonomy, with dense taxonomy ids."""
    monkeypatch.setattr(TS, "TAXON_BITS", 2)
    c, kraken, report = _port(device_counters=True, value_pool=False)
    assert c._pool is None
    assert c.dev_counters.host_stats and c.dev_counters.sparse_cap == 0
    assert c.dev_counters.lut is not None
    assert kraken == _golden("kraken.out")
    assert report == _golden("report.tsv")
    _, kraken_h, report_h = _port(value_pool=False)
    assert (kraken_h, report_h) == (kraken, report)


def test_with_shared_db_reuses_tables():
    base, kraken, report = _port()
    c = Classifier.with_shared_db(base, device_counters=True)
    assert c.dbs is base.dbs and c.dev_counters is not None and base.dev_counters is None
    k2, r2 = io.StringIO(), io.StringIO()
    c.run([READS], kraken_fh=k2)
    c.write_report(r2)
    assert (k2.getvalue(), r2.getvalue()) == (kraken, report)
    with pytest.raises(ValueError, match="value_pool"):
        Classifier.with_shared_db(base, value_pool=False)


def test_cli_device_counters(tmp_path):
    out, rep = tmp_path / "kraken.out", tmp_path / "report.tsv"
    rc = cli_main([
        "--db", DATA, "--device", "cpu", "--device-counters", "--output", str(out),
        "--report-file", str(rep), READS,
    ])
    assert rc == 0
    assert out.read_text() == _golden("kraken.out")
    lines = rep.read_text().splitlines(keepends=True)
    assert lines[1].startswith("# CL:") and "--device-counters" in lines[1]
    assert "".join(lines[2:]) == _golden("report.tsv")
