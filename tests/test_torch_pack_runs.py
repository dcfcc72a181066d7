"""`pack_runs` with the span step's fused u16 HLL feed, in the port
(krakenuniq_tpu_torch) on the CPU against the JAX package, integer for
integer: `pack_runs_plain` with `hll16` / `hll_stop` against the JAX
`_pack_runs` plus the JAX step's `hll_dense` expression
(krakenuniq_tpu/classify/device_step.py:389-391), in the three row layouts
at R = 2 and 8, at the shapes that cut the kernel's tiles (16 reads a tile:
B = 1, 7, 16, 65 leaves ragged last tiles; W = 1, 31, 33, 130, 161) and on
the edge inputs (n_kmers 0 and past W, all-ambiguous reads, a quick-mode
cut below n_kmers, rows with more runs than slots); and the span config of
`classify_step_core`, which builds `processed` and `hll_lanes` only when
they are asked for."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import _pack_runs, classify_step
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify.device_step import (
    StepConfig,
    classify_step_core,
    hll_feed_plain,
    pack_runs,
    pack_runs_plain,
)
from krakenuniq_tpu_torch.db.device_db import device_db_from_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
T = torch.from_numpy
LAYOUTS = ("compact", "dense", "wide")


def _inputs(rng, b, w):
    """Random ids (some past u16) with ~15% ambiguous lanes of varied ids;
    rows cycle through the edge cases: all ambiguous, n_kmers 0, n_kmers
    past W, a fresh id at every lane (overflow rows), n_kmers 1, random.
    hll_stop: each read's valid lanes (min(n_kmers, W)), or for every
    other read a quick-mode cut below it."""
    ids = rng.integers(0, 4, size=(b, w)).astype(np.int32)
    ids[rng.random((b, w)) < 0.05] = 70_001
    amb = rng.random((b, w)) < 0.15
    ids[amb] = rng.integers(0, 9, size=int(amb.sum()))
    nk = rng.integers(0, w + 1, size=b).astype(np.int32)
    kind = np.arange(b) % 6
    amb[kind == 0] = True
    nk[kind == 0] = w
    nk[kind == 1] = 0
    nk[kind == 2] = w + 5
    ids[kind == 3] = rng.integers(0, 1 << 20, size=(int((kind == 3).sum()), w))
    nk[kind == 3] = w
    nk[kind == 4] = 1
    call = rng.integers(-(1 << 31), 1 << 31, size=b).astype(np.int32)
    hits = rng.integers(0, 300, size=b).astype(np.int32)
    stop = np.clip(nk, 0, w)
    cut = np.arange(b) % 2 == 1
    stop[cut] = rng.integers(0, stop[cut] + 1)
    return ids, amb, nk, call, hits, stop.astype(np.int32)


def _want(ids, amb, nk, call, hits, stop, r, layout, table):
    """The JAX `_pack_runs` rows and the JAX step's hll_dense for the
    processed prefix lane < stop."""
    w = ids.shape[1]
    valid = np.arange(w)[None, :] < nk[:, None]
    rows = _pack_runs(
        jnp.asarray(ids.view(np.uint32)), jnp.asarray(amb), jnp.asarray(valid),
        jnp.asarray(call.view(np.uint32)), jnp.asarray(hits), jnp.asarray(nk), r,
        dense_words=layout != "wide", compact_meta=layout == "compact",
        map_table=None if table is None else jnp.asarray(table),
    )
    processed = jnp.asarray(np.arange(w)[None, :] < stop[:, None])
    hll = jnp.where(processed & ~jnp.asarray(amb), jnp.asarray(ids).astype(jnp.uint16), jnp.uint16(0xFFFF))
    return np.asarray(rows), np.asarray(hll)


def _check(b, w, r, layout, seed):
    rng = np.random.default_rng(seed)
    ids, amb, nk, call, hits, stop = _inputs(rng, b, w)
    table = None
    if layout == "wide":
        table = rng.integers(0, 1 << 32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
        table[0] = 0
    want_rows, want_hll = _want(ids, amb, nk, call, hits, stop, r, layout, table)
    mt = None if table is None else T(table.view(np.int32))
    args = (T(ids), T(amb), T(nk), T(call), T(hits), r, layout, mt)
    rows, hll = pack_runs_plain(*args, hll16=True, hll_stop=T(stop))
    assert rows.dtype == torch.int32 and hll.dtype == torch.int16 and hll.shape == (b, w)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32), want_rows)
    np.testing.assert_array_equal(hll.numpy().view(np.uint16), want_hll)
    # the wrapper takes the plain version for CPU tensors; without the feed
    # it returns the rows alone, as before
    got = pack_runs(*args, hll16=True, hll_stop=T(stop))
    assert torch.equal(got[0], rows) and torch.equal(got[1], hll)
    assert torch.equal(pack_runs(*args), rows)
    return want_rows


@pytest.mark.parametrize("r", [2, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pack_runs_with_feed_matches_jax(layout, r):
    rows = _check(65, 130, r, layout, seed=r)
    n_runs = rows[:, -1] & 0xFFFF
    assert (n_runs > r).any() and (n_runs == 0).any()  # overflow rows and empty rows ran


# every (B, W) pair of the tile edges; the layout and R cycle over the cases
SHAPES = [(b, w) for w in (1, 31, 33, 130, 161) for b in (1, 7, 16, 65)]


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=[f"B{b}-W{w}" for b, w in SHAPES])
def test_pack_runs_tile_shapes_match_jax(i):
    b, w = SHAPES[i]
    _check(b, w, (2, 8)[i % 2], LAYOUTS[i % 3], seed=100 + i)


def test_feed_default_stop_is_n_kmers():
    """hll_stop=None counts every valid lane (the step's non-quick feed),
    n_kmers past W clamped to the row."""
    rng = np.random.default_rng(5)
    ids, amb, nk, call, hits, _ = _inputs(rng, 40, 33)
    _, hll = pack_runs_plain(T(ids), T(amb), T(nk), T(call), T(hits), 8, "compact", hll16=True)
    _, want = _want(ids, amb, nk, call, hits, np.clip(nk, 0, 33), 8, "compact", None)
    np.testing.assert_array_equal(hll.numpy().view(np.uint16), want)
    assert torch.equal(hll, hll_feed_plain(T(ids), T(amb), T(nk)))


@pytest.mark.parametrize(
    "kwargs,match",
    [({"hll_stop": torch.zeros(4, dtype=torch.int32)}, "belongs to the hll16 feed"),
     ({"hll16": True, "hll_stop": torch.zeros(3, dtype=torch.int32)}, "int32 \\[B\\]"),
     ({"hll16": True, "hll_stop": torch.zeros(4, dtype=torch.int64)}, "int32 \\[B\\]")],
    ids=["stop-without-feed", "stop-shape", "stop-dtype"],
)
def test_pack_runs_refuses_bad_feed_arguments(kwargs, match):
    z = torch.zeros((4, 9), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pack_runs(z, z.bool(), n, n, n, 8, "compact", **kwargs)


def _golden_span(quick, min_hits, outputs):
    """The JAX classify_step and the port's classify_step_core on the golden
    reads (parsed and bit-packed by the port's native module) with the span
    route's options and `outputs`."""
    jc = JaxClassifier(
        [DATA], JaxOptions(print_progress=False, use_native=False, quick=quick, min_hits=min_hits)
    )
    with open(os.path.join(DATA, "reads.fa"), "rb") as f:
        buf = f.read() + b">n\n" + b"N" * 40 + b"\n>m\n" + b"ACGTN" * 20 + b"\n"
    nat = _native_build.native()
    n, offs, _ = nat.parse_unit(buf, False)
    codes, ambig, lengths = nat.encode_unit_packed(buf, np.ascontiguousarray(offs), 160, 160)
    jcfg = dataclasses.replace(jc._cfg, packed_input=True, max_runs=8, dense_runs=True, outputs=outputs)
    want = classify_step(
        jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
        codes, ambig, lengths, jcfg,
    )
    plane = device_db_from_host(
        tuple(np.asarray(p) for p in jc.dbs[0].hash_table), jc.dbs[0].hash_lb, jc._pool, jc.k, jc.nt, "cpu"
    ).hash_table
    t = lambda a: T(np.array(a).view(np.int32))
    cfg = StepConfig(
        k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick, min_hits=min_hits,
        packed_input=True, max_runs=8, dense_runs=True, outputs=outputs,
    )
    got = classify_step_core(
        (plane,), t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1), t(jc._parent),
        int(jc._root_dense), T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths), cfg,
    )
    return got, want


SPAN = ("packed", "taxa_dense", "ambig", "hll_enc", "hll_dense")


@pytest.mark.parametrize("quick,min_hits", [(False, 1), (True, 2)], ids=["compact", "quick"])
@pytest.mark.parametrize("extra", [(), ("processed", "hll_lanes")], ids=["span", "span+lanes"])
def test_span_step_returns_lanes_only_when_asked(quick, min_hits, extra):
    """The span config returns exactly its outputs (the fused feed stands
    in for `hll_lanes`); asked for `processed` and `hll_lanes` as well, the
    step returns them too. Every output equals the JAX step's."""
    outputs = SPAN + extra
    got, want = _golden_span(quick, min_hits, outputs)
    assert tuple(got) == outputs and set(want) == set(outputs)
    for key in outputs:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)


@pytest.mark.parametrize("quick,min_hits", [(False, 1), (True, 2)], ids=["compact", "quick"])
def test_span_step_launches_the_feed_only_when_asked(quick, min_hits, monkeypatch):
    """Without hll_dense among the outputs (the device-counters span) the
    step packs its rows without the feed, and the rows equal those of the
    step with the feed."""
    from krakenuniq_tpu_torch.classify import device_step

    feeds = []
    real = device_step.pack_runs
    monkeypatch.setattr(device_step, "pack_runs", lambda *a, **k: feeds.append(k["hll16"]) or real(*a, **k))
    with_feed, _ = _golden_span(quick, min_hits, SPAN)
    without, want = _golden_span(quick, min_hits, ("packed", "taxa_dense", "ambig"))
    assert feeds == [True, False]
    assert tuple(without) == ("packed", "taxa_dense", "ambig")
    assert torch.equal(with_feed["packed"], without["packed"])
    np.testing.assert_array_equal(without["packed"].numpy().view(np.uint32), np.asarray(want["packed"]))
