"""The span route's device side in the port (krakenuniq_tpu_torch) on the CPU
against the JAX package, integer for integer: `pack_runs_plain` against
`_pack_runs` in its three row layouts, `unpack_input` and the packed-input
k-mer front against `unpack_input` and the JAX front, the span step config
of `classify_step_core` (compact and wide rows) against the JAX step with
the same options on the golden databases, and the native CHD placement
against the JAX package's native `chd_place` built from
native/kuniq_native.cpp."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import _pack_runs, classify_step
from krakenuniq_tpu.classify.device_step import encode_hash_device as jax_encode
from krakenuniq_tpu.classify.device_step import murmur3_finalizer_device as jax_murmur
from krakenuniq_tpu.classify.device_step import unpack_input as jax_unpack
from krakenuniq_tpu.kmer import ops as jax_ops
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify.device_step import (
    StepConfig,
    classify_step_core,
    kmer_front_words,
    pack_input,
    pack_runs,
    pack_runs_plain,
    unpack_input,
)
from krakenuniq_tpu_torch.db.device_db import device_db_from_host
from krakenuniq_tpu_torch.db.hash_table import _chd_place, _chd_place_numpy, build_hash_table
from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
T = torch.from_numpy


def _rle_inputs(rng, b, w):
    """Per-read planes with every kind of row: random ids (some past u16),
    runs of ambiguous lanes carrying varied ids, all-ambiguous rows, rows
    with more runs than slots, reads shorter than k (n_kmers 0) and full
    rows."""
    ids = rng.integers(0, 4, size=(b, w)).astype(np.int32)
    ids[rng.random((b, w)) < 0.05] = 70_001
    amb = rng.random((b, w)) < 0.15
    amb[0] = True  # all ambiguous
    amb[1, : w // 2] = True
    ids[amb] = rng.integers(0, 9, size=int(amb.sum()))
    nk = rng.integers(0, w + 1, size=b).astype(np.int32)
    nk[2:4] = 0  # shorter than k
    nk[:2] = w
    nk[4] = 1
    call = rng.integers(-(1 << 31), 1 << 31, size=b).astype(np.int32)
    hits = rng.integers(0, 300, size=b).astype(np.int32)
    return ids, amb, nk, call, hits


@pytest.mark.parametrize("r", [2, 8])
@pytest.mark.parametrize("layout", ["compact", "dense", "wide"])
def test_pack_runs_plain_matches_jax(layout, r):
    rng = np.random.default_rng(r)
    ids, amb, nk, call, hits = _rle_inputs(rng, 96, 70)
    table = rng.integers(0, 1 << 32, size=70_002, dtype=np.uint64).astype(np.uint32)
    table[0] = 0
    valid = np.arange(ids.shape[1])[None, :] < nk[:, None]
    want = _pack_runs(
        jnp.asarray(ids.view(np.uint32)), jnp.asarray(amb), jnp.asarray(valid),
        jnp.asarray(call.view(np.uint32)), jnp.asarray(hits), jnp.asarray(nk), r,
        dense_words=layout != "wide", compact_meta=layout == "compact",
        map_table=jnp.asarray(table) if layout == "wide" else None,
    )
    mt = T(table.view(np.int32)) if layout == "wide" else None
    got = pack_runs_plain(T(ids), T(amb), T(nk), T(call), T(hits), r, layout, mt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(pack_runs(T(ids), T(amb), T(nk), T(call), T(hits), r, layout, mt), got)
    n_runs = np.asarray(want)[:, -1] & 0xFFFF
    assert (n_runs > r).any() and (n_runs == 0).any()  # overflow rows and empty rows ran


@pytest.mark.parametrize(
    "r,w,match",
    [(3, 40, "even"), (0, 40, "even"), (8, 1 << 15, "2\\^15")],
    ids=["odd-R", "zero-R", "wide-W"],
)
def test_pack_runs_refuses_bad_shapes(r, w, match):
    z = torch.zeros((2, w), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pack_runs(z, z.bool(), n, n, n, r, "compact")


@pytest.mark.parametrize("lb", [32, 160, 512])
def test_unpack_input_matches_jax(lb):
    rng = np.random.default_rng(lb)
    cw = rng.integers(0, 1 << 32, size=(9, lb // 16), dtype=np.uint64).astype(np.uint32)
    aw = rng.integers(0, 1 << 32, size=(9, lb // 32), dtype=np.uint64).astype(np.uint32)
    want_c, want_a = jax_unpack(jnp.asarray(cw), jnp.asarray(aw))
    got_c, got_a = unpack_input(T(cw.view(np.int32)), T(aw.view(np.int32)))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("k,lb", [(31, 160), (21, 96), (31, 32)])
def test_packed_front_matches_jax(k, lb):
    rng = np.random.default_rng(k + lb)
    codes = T(rng.integers(0, 4, size=(17, lb), dtype=np.uint8))
    ambig = T(rng.random((17, lb)) < 0.03)
    cw, aw = pack_input(codes, ambig)
    jc, ja = jax_unpack(jnp.asarray(cw.numpy().view(np.uint32)), jnp.asarray(aw.numpy().view(np.uint32)))
    want_h = jax_murmur(jax_ops.canonical_representation(jax_ops.pack_windows(jc, k), k))
    want = (want_h, jax_encode(want_h, 12), jax_ops.window_any(ja, k))
    got = kmer_front_words(cw, aw, k, 12)
    for g, w, dt in zip(got, want, (np.uint64, np.uint32, bool)):
        np.testing.assert_array_equal(g.numpy().view(dt), np.asarray(w))


def _span_feed(lb=160, b=192):
    """The golden reads plus an empty read, one shorter than k, an all-N one
    and an N-riddled one, parsed and bit-packed by the port's native
    module (padding positions ambiguous, as the span route feeds them)."""
    with open(os.path.join(DATA, "reads.fa"), "rb") as f:
        buf = f.read() + b">e\n\n>s\nACGTACGTACGT\n>n\n" + b"N" * 40 + b"\n>m\n" + b"ACGTN" * 20 + b"\n"
    nat = _native_build.native()
    n, offs, multi = nat.parse_unit(buf, False)
    assert not multi and n == 146
    return nat.encode_unit_packed(buf, np.ascontiguousarray(offs), lb, b)


SPAN_OUTPUTS = ("packed", "taxa_dense", "ambig", "hll_enc", "hll_dense")


@pytest.mark.parametrize(
    "dbs,quick,min_hits",
    [(["."], False, 1), (["."], True, 2), (["db_bact", "db_viral"], False, 1),
     (["db_bact", "db_viral"], True, 1)],
    ids=["compact", "quick", "hierarchical", "hierarchical-quick"],
)
def test_span_step_matches_jax(dbs, quick, min_hits):
    jc = JaxClassifier(
        [os.path.join(DATA, d) for d in dbs],
        JaxOptions(print_progress=False, use_native=False, quick=quick, min_hits=min_hits),
    )
    outputs = SPAN_OUTPUTS
    # the options Classifier._configure gives _cfg_packed on the span route
    jcfg = dataclasses.replace(
        jc._cfg, packed_input=True, max_runs=8, dense_runs=True, outputs=outputs
    )
    codes, ambig, lengths = _span_feed()
    want = classify_step(
        jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
        codes, ambig, lengths, jcfg,
    )
    planes = tuple(
        device_db_from_host(
            tuple(np.asarray(p) for p in db.hash_table), db.hash_lb, jc._pool, jc.k, jc.nt, "cpu"
        ).hash_table
        for db in jc.dbs
    )
    t = lambda a, dt: T(np.array(a).view(dt))
    cfg = StepConfig(
        k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick, min_hits=min_hits,
        packed_input=True, max_runs=8, dense_runs=True, outputs=outputs,
    )
    got = classify_step_core(
        planes, t(jc._taxid_table, np.int32),
        torch.stack([t(jc._tin, np.int32), t(jc._tout, np.int32)], dim=1),
        t(jc._parent, np.int32), int(jc._root_dense),
        T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths), cfg,
    )
    assert tuple(got) == outputs and set(want) == set(outputs)
    for key in outputs:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)
    packed = np.asarray(want["packed"])
    assert (packed[:, :8] != 0).any()


@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_span_step_wide_rows_not_yet_in_the_step(quick):
    """The step's wide RLE rows (dense_runs=False: run values mapped to
    taxids through taxid_table) and their u64 hll_pairs feed, the span
    dictionary's overflow route, equal the JAX step's."""
    codes, ambig, lengths = _span_feed(b=64)
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False, quick=quick))
    outputs = ("packed", "taxa_dense", "ambig", "hll_pairs")
    jcfg = dataclasses.replace(jc._cfg, packed_input=True, max_runs=8, outputs=outputs)
    want = classify_step(
        jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
        codes, ambig, lengths, jcfg,
    )
    planes = (
        device_db_from_host(
            tuple(np.asarray(p) for p in jc.dbs[0].hash_table), jc.dbs[0].hash_lb, jc._pool,
            jc.k, jc.nt, "cpu",
        ).hash_table,
    )
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, quick=quick, packed_input=True, max_runs=8,
                     outputs=outputs)
    t = lambda a: T(np.array(a).view(np.int32))
    got = classify_step_core(
        planes, t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1),
        t(jc._parent), int(jc._root_dense),
        T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths), cfg,
    )
    assert tuple(got) == outputs
    for key in outputs:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)
    pairs = np.asarray(want["hll_pairs"])
    assert (pairs != np.uint64(0xFFFFFFFFFFFFFFFF)).any() and (pairs == np.uint64(0xFFFFFFFFFFFFFFFF)).any()


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, compiled here from
    native/kuniq_native.cpp (with the port's compiler flags) so the
    comparison does not depend on the JAX package's own in-place build."""
    import subprocess

    out = tmp_path_factory.mktemp("jax_native") / "kuniq_native.so"
    cmd = [
        *_native_build._compiler(), *_native_build.CXXFLAGS, *_native_build._includes(),
        os.path.join(ROOT, "native", "kuniq_native.cpp"), "-o", str(out),
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    spec = importlib.util.spec_from_file_location("kuniq_native", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,lr,seed", [(1000, 11, 0), (30_000, 16, 1), (100_000, 17, 2)])
def test_chd_place_matches_jax_native(jax_native, n, lr, seed):
    rng = np.random.default_rng(seed)
    hashes = murmur3_finalizer(np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64)))
    got = _chd_place(hashes, lr, lr - 2, seed=seed)
    want = jax_native.chd_place(hashes, lr, lr - 2, seed, 65536)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [5000, 60_000])
def test_native_placed_table_probes_every_key(n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    vals = rng.integers(1, 503, size=len(keys)).astype(np.uint32)
    host, lr = build_hash_table(keys, vals)  # the native placement, self-checked
    h = T(murmur3_finalizer(keys).view(np.int64))
    valid = torch.ones(len(keys), dtype=torch.bool)
    db = device_db_from_host(host, lr, None, 31, 12, "cpu")
    np.testing.assert_array_equal(hash_lookup_kmers(db.hash_table, h, valid).numpy(), vals)
    # the numpy placement of the same keys: other planes, the same values
    hashes = murmur3_finalizer(keys)
    native = _chd_place(hashes, lr, lr - 2)
    plain = _chd_place_numpy(hashes, lr, lr - 2)
    assert native is not None and plain is not None
    rows_n, rows_p = native[0], plain[0]
    assert len(np.unique(rows_n.astype(np.int64) * 2 + native[1])) == len(keys)
    assert len(np.unique(rows_p.astype(np.int64) * 2 + plain[1])) == len(keys)
