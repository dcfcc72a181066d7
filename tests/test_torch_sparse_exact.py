"""The port's sparse-regime statistics (krakenuniq_tpu_torch.classify.
sparse_exact) against the JAX package's: `sparse_stats_core` buffer, pair
and event counts equal integer for integer, and both equal the real
per-unit HLL fold, as tests/test_sparse_exact.py checks the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import sparse_exact as JS
from krakenuniq_tpu_torch.classify import sparse_exact as TS
from krakenuniq_tpu_torch.hll import HLL

P = 6  # threshold m/4 = 16: easy to hit the edge cases
TH = (1 << P) // 4

_jit_stats = jax.jit(JS.sparse_stats_core, static_argnums=(4, 5))


def _oracle(taxa, enc, lanes, unit_bounds):
    """The real per-unit HLL fold: (pairs, dense events)."""
    pairs, dense = set(), []
    for s, e in zip(unit_bounds[:-1], unit_bounds[1:]):
        t = taxa[s:e][lanes[s:e]]
        v = enc[s:e][lanes[s:e]]
        for taxon in np.unique(t):
            h = HLL(P)
            h.insert_encodings(v[t == taxon])
            if h.sparse:
                pairs.update((int(taxon), int(x)) for x in h.sparse_set)
            else:
                dense.append(int(taxon))
    return pairs, sorted(dense)


def _decode(buf, n_p, n_e):
    mask = np.uint64((1 << TS.TAXON_BITS) - 1)
    pairs = buf[:n_p]
    taxa = ((pairs >> np.uint64(32)) & mask).astype(np.int64)
    encs = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ev = sorted(int(x & mask) for x in buf[n_p : n_p + n_e])
    return set(zip(taxa.tolist(), encs.tolist())), ev


def _both(taxa, enc, lanes, unit_id, cap):
    """(JAX stats, port stats) as numpy (buf u64, n_p, n_e)."""
    jb, jp, je = _jit_stats(
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(unit_id), P, cap
    )
    tb, tp, te = TS.sparse_stats_core(
        torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)),
        torch.from_numpy(lanes), torch.from_numpy(unit_id.astype(np.int64)), P, cap,
    )
    assert tb.dtype == torch.int64 and tp.dtype == te.dtype == torch.int32
    return (np.asarray(jb), int(jp), int(je)), (tb.numpy().view(np.uint64), int(tp), int(te))


@pytest.mark.parametrize("trial", range(8))
def test_sparse_stats_core_matches_jax_and_oracle(trial):
    rng = np.random.default_rng(trial)
    b, w = 32, 40
    unit_bounds = [0, 10, 22, 32]
    unit_id = np.zeros(b, np.uint8)
    for u, (s, e) in enumerate(zip(unit_bounds[:-1], unit_bounds[1:])):
        unit_id[s:e] = u
    taxa = rng.integers(0, 6, size=(b, w)).astype(np.int32)
    # a small encoding alphabet forces near-threshold distinct counts, and
    # taxa 4-5 draw from fewer than m/4 values so some groups stay sparse:
    # the buffer then holds pairs, events (tag bit 63) and pads (all ones),
    # which only an unsigned key order puts in that order
    alphabet = np.where(taxa >= 4, TH - 4, TH + 3)
    enc = (rng.integers(0, alphabet).astype(np.uint32)) * 7 + 1
    enc[taxa % 2 == 1] |= np.uint32(1 << 31)
    lanes = rng.random((b, w)) < 0.8

    (jb, jp, je), (tb, tp, te) = _both(taxa, enc, lanes, unit_id, 4096)
    assert (tp, te) == (jp, je)
    assert tp > 0 and te > 0, "the buffer should hold pairs and events"
    np.testing.assert_array_equal(tb, jb)  # used prefix and the pad tail

    want_pairs, want_dense = _oracle(taxa, enc, lanes, unit_bounds)
    assert _decode(tb, tp, te) == (want_pairs, want_dense)
    pt, pe, dt = TS.sparse_stats_host(taxa, enc, lanes, unit_bounds, TH)
    assert set(zip(pt.tolist(), pe.tolist())) == want_pairs
    assert sorted(dt.tolist()) == want_dense
    for got, want in zip((pt, pe, dt), JS.sparse_stats_host(taxa, enc, lanes, unit_bounds, TH)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [3, 1 << 20])
def test_sparse_stats_core_buffer_cap(cap):
    """A cap below the emitted count truncates the buffer exactly as the
    JAX slice does (the caller sees n_p + n_e > len(buf)); a cap above the
    lane count leaves one slot per lane."""
    rng = np.random.default_rng(11)
    taxa = rng.integers(0, 4, size=(8, 16)).astype(np.int32)
    enc = rng.integers(1, 1 << 32, size=(8, 16), dtype=np.uint64).astype(np.uint32)
    lanes = rng.random((8, 16)) < 0.9
    (jb, jp, je), (tb, tp, te) = _both(taxa, enc, lanes, np.zeros(8, np.uint8), cap)
    assert (tp, te) == (jp, je) and len(tb) == len(jb) == min(cap, taxa.size)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("last_dup", [False, True])
def test_threshold_edge(last_dup):
    """d == m/4 exactly: the counter goes dense only if the set fills BEFORE
    the unit's last insert; a trailing duplicate flips the outcome."""
    stream = np.arange(1, TH + 1, dtype=np.uint32)
    if last_dup:
        stream = np.concatenate([stream, stream[:1]])
    h = HLL(P)
    h.insert_encodings(stream)
    assert h.sparse == (not last_dup)

    taxa = np.full((1, len(stream)), 3, np.int32)
    enc = stream[None, :]
    lanes = np.ones((1, len(stream)), bool)
    _, _, dt = TS.sparse_stats_host(taxa, enc, lanes, [0, 1], TH)
    assert (len(dt) == 1) == last_dup
    (jb, jp, je), (tb, tp, te) = _both(taxa, enc, lanes, np.zeros(1, np.uint8), 4096)
    assert (tp, te) == (jp, je)
    assert (te == 1) == last_dup
    assert (tp == 0) == last_dup
    np.testing.assert_array_equal(tb, jb)


def test_tracker_union_and_final_state():
    """Union across spans and units equals one big host fold, and equals the
    JAX tracker's; a taxon dense in ANY unit is dense forever."""
    rng = np.random.default_rng(7)
    tr, jtr = TS.SparseTracker(), JS.SparseTracker()
    all_pairs: dict[int, set] = {}
    dense: set[int] = set()
    for _ in range(4):
        taxa = rng.integers(0, 5, size=(16, 24)).astype(np.int32)
        enc = (rng.integers(0, TH + 2, size=(16, 24)).astype(np.uint32)) * 3 + 1
        lanes = rng.random((16, 24)) < 0.9
        ub = [0, 7, 16]
        stats = TS.sparse_stats_host(taxa, enc, lanes, ub, TH)
        tr.add(*stats)
        jtr.add(*stats)
        dense.update(int(x) for x in stats[2])
        for t, v in zip(stats[0].tolist(), stats[1].tolist()):
            all_pairs.setdefault(t, set()).add(v)
    assert tr.dense_ever == dense == jtr.dense_ever
    for t, vals in all_pairs.items():
        got = tr.sparse_set_of(t)
        assert set(got.tolist()) == vals
        assert (np.sort(got) == got).all()
        np.testing.assert_array_equal(got, jtr.sparse_set_of(t))


def test_tracker_consumes_device_buffer():
    """A port buffer folds into the tracker exactly as the JAX buffer folds
    into the JAX tracker."""
    rng = np.random.default_rng(3)
    taxa = rng.integers(0, 6, size=(12, 30)).astype(np.int32)
    enc = (rng.integers(0, TH + 3, size=(12, 30)).astype(np.uint32)) * 5 + 1
    lanes = rng.random((12, 30)) < 0.85
    unit_id = np.repeat(np.arange(3, dtype=np.uint8), 4)
    (jb, jp, je), (tb, tp, te) = _both(taxa, enc, lanes, unit_id, 4096)
    tr, jtr = TS.SparseTracker(), JS.SparseTracker()
    assert tr.consume_buffer(torch.from_numpy(tb[: tp + te].view(np.int64)), tp, te)
    assert jtr.consume_buffer(jb[: jp + je], jp, je)
    assert tr.dense_ever == jtr.dense_ever
    for t in range(6):
        np.testing.assert_array_equal(tr.sparse_set_of(t), jtr.sparse_set_of(t))


def test_tracker_overflow_flag():
    tr = TS.SparseTracker()
    buf = torch.zeros(4, dtype=torch.int64)
    assert not tr.consume_buffer(buf, 3, 2)  # 5 > 4 slots
    assert tr.overflows == 1


def test_constants_match_jax():
    assert (TS.TAXON_BITS, TS.UNIT_BITS, TS.MAX_UNITS) == (JS.TAXON_BITS, JS.UNIT_BITS, JS.MAX_UNITS)


def _span_planes(rng, b, w, n_units, n_taxa):
    """zipf-1.5 taxa over n_taxa ids; random encodings on the five most
    frequent taxa (they go dense), a few hundred distinct ones on the tail
    (it stays sparse)."""
    taxa = (rng.zipf(1.5, size=(b, w)) % n_taxa).astype(np.int32)
    enc = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    tail = taxa >= 5
    enc[tail] = (rng.integers(0, 300, size=int(tail.sum())).astype(np.uint32) << 7) | 3
    lanes = rng.random((b, w)) < 0.9
    unit_id = np.repeat(np.arange(n_units), -(-b // n_units))[:b].astype(np.uint8)
    return taxa, enc, lanes, unit_id


def _both_p12(taxa, enc, lanes, unit_id, cap):
    args = (torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)), torch.from_numpy(lanes),
            torch.from_numpy(unit_id.astype(np.int64)), 12, cap)
    jb, jp, je = jax.jit(JS.sparse_stats_core, static_argnums=(4, 5))(
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(unit_id), 12, cap)
    got = TS.sparse_stats(*args)  # the wrapper takes the plain version on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, TS.sparse_stats_core(*args)))
    tb, tp, te = got
    assert (int(tp), int(te)) == (int(jp), int(je))
    np.testing.assert_array_equal(tb.numpy().view(np.uint64), np.asarray(jb))
    return int(tp), int(te)


@pytest.mark.parametrize("case", ["64-units", "giant-group", "cap-edge"])
def test_sparse_stats_span_shapes_match_jax(case):
    """Span-like inputs at p = 12: 64 work units of zipf taxa; one unit whose
    every lane is one taxon (one group across the whole plane); and a cap at
    the emitted count and one below it (truncation)."""
    rng = np.random.default_rng(["64-units", "giant-group", "cap-edge"].index(case))
    if case == "giant-group":
        taxa = np.zeros((512, 130), np.int32)
        enc = rng.integers(0, 1 << 32, size=taxa.shape, dtype=np.uint64).astype(np.uint32)
        n_p, n_e = _both_p12(taxa, enc, np.ones(taxa.shape, bool), np.zeros(512, np.uint8), 1 << 21)
        assert (n_p, n_e) == (0, 1)
        return
    planes = _span_planes(rng, 4096 if case == "64-units" else 1024, 130, 64 if case == "64-units" else 3, 503)
    n_p, n_e = _both_p12(*planes, 1 << 21)
    assert n_p > 0 and n_e > 0
    if case == "64-units":
        assert n_e >= 64  # every unit's most frequent taxon goes dense
    else:
        for cap in (n_p + n_e, n_p + n_e - 1, n_p - 1):
            _both_p12(*planes, cap)


def _torch_args(taxa, enc, lanes, unit_id):
    return (torch.from_numpy(taxa), torch.from_numpy(enc.view(np.int32)), torch.from_numpy(lanes),
            torch.from_numpy(unit_id))


def _hold_tiles(taxa, enc, lanes, unit_id, p, cap, tile):
    """The tiled mirror of the card's kernels against sparse_stats_core and
    the JAX package's, integer for integer; returns (n_pairs, n_events)."""
    args = _torch_args(taxa, enc, lanes, unit_id)
    got = TS.sparse_stats_tiles(*args, p, cap, tile=tile)
    want = TS.sparse_stats_core(*args, p, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jb, jp, je = jax.jit(JS.sparse_stats_core, static_argnums=(4, 5))(
        jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(unit_id), p, cap)
    assert (int(got[1]), int(got[2])) == (int(jp), int(je))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64), np.asarray(jb))
    return int(got[1]), int(got[2])


@pytest.mark.parametrize("tile", [8, 64])
@pytest.mark.parametrize("trial", range(8))
def test_sparse_stats_tiles_match_jax(trial, tile):
    """The kernels' algorithm (decide over tiles with the carried segmented
    state, emit from the last tile with the carried counts) at small tiles,
    on the trials of test_sparse_stats_core_matches_jax_and_oracle."""
    rng = np.random.default_rng(trial)
    b, w = 32, 40
    unit_id = np.repeat(np.arange(3, dtype=np.uint8), [10, 12, 10])
    taxa = rng.integers(0, 6, size=(b, w)).astype(np.int32)
    alphabet = np.where(taxa >= 4, TH - 4, TH + 3)
    enc = (rng.integers(0, alphabet).astype(np.uint32)) * 7 + 1
    enc[taxa % 2 == 1] |= np.uint32(1 << 31)
    lanes = rng.random((b, w)) < 0.8
    n_p, n_e = _hold_tiles(taxa, enc, lanes, unit_id, P, 4096, tile)
    assert n_p > 0 and n_e > 0


@pytest.mark.parametrize(
    "case", ["sparse-across-tiles", "no-counted-lane", "edge-no-dup", "edge-last-dup", "cap-below"])
def test_sparse_stats_tiles_edges(case):
    """A stayed-sparse group over many tiles of duplicates; no counted
    lane; d == m/4 with and without a last duplicate, the group's lanes cut
    across tiles; a cap below the entry count."""
    rng = np.random.default_rng(5)
    if case == "sparse-across-tiles":
        taxa = np.full((16, 40), 2, np.int32)  # 640 lanes of one group: 80 tiles of 8
        enc = (rng.integers(0, TH - 1, size=taxa.shape).astype(np.uint32) << 7) | 1
        n_p, n_e = _hold_tiles(taxa, enc, np.ones(taxa.shape, bool), np.zeros(16, np.uint8), P, 4096, 8)
        assert (n_p, n_e) == (len(np.unique(enc)), 0)
    elif case == "no-counted-lane":
        taxa = rng.integers(0, 6, size=(8, 30)).astype(np.int32)
        enc = rng.integers(1, 1 << 32, size=taxa.shape, dtype=np.uint64).astype(np.uint32)
        n_p, n_e = _hold_tiles(taxa, enc, np.zeros(taxa.shape, bool), np.zeros(8, np.uint8), P, 4096, 8)
        assert (n_p, n_e) == (0, 0)
    elif case.startswith("edge"):
        stream = np.arange(1, TH + 1, dtype=np.uint32)
        if case == "edge-last-dup":
            stream = np.concatenate([stream, stream[:1]])
        # the group's lanes interleaved with uncounted lanes and another taxon
        taxa = np.full((1, 3 * len(stream)), 5, np.int32)
        enc = np.repeat(stream, 3)[None, :]
        lanes = np.zeros(taxa.shape, bool)
        lanes[0, ::3] = True
        taxa[0, 1::3] = 1
        lanes[0, 1::3] = True
        for tile in (1, 3, 5):
            _, n_e = _hold_tiles(taxa, enc, lanes, np.zeros(1, np.uint8), P, 4096, tile)
            assert (n_e >= 1) == (case == "edge-last-dup")
    else:
        planes = _span_planes(rng, 64, 130, 5, 503)
        n_p, n_e = _hold_tiles(*planes, 12, 1 << 20, 512)
        for cap in (n_p + n_e - 1, n_p - 1, 1):
            _hold_tiles(*planes, 12, cap, 512)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_sparse_keys_form(dtype):
    """The key build's output: the JAX package's key unit<<57 | taxon<<32 |
    enc (uint64, all ones off the counted lanes) with the sign bit flipped,
    for each unit id type the kernel reads as it is."""
    rng = np.random.default_rng(9)
    taxa = rng.integers(0, 1 << 25, size=(6, 7)).astype(np.int32)
    enc = rng.integers(0, 1 << 32, size=taxa.shape, dtype=np.uint64).astype(np.uint32)
    lanes = rng.random(taxa.shape) < 0.7
    unit = rng.integers(0, 64, size=6).astype(dtype)
    key = ((unit.astype(np.uint64)[:, None] << np.uint64(57)) | (taxa.astype(np.uint64) << np.uint64(32))
           | enc.astype(np.uint64))
    want = np.where(lanes, key, np.uint64(TS._PAD_INT)).reshape(-1) ^ np.uint64(1 << 63)
    got = TS.sparse_keys(*_torch_args(taxa, enc, lanes, unit))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
