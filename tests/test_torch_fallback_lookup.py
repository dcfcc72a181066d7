"""The port's fallback lookups on the CPU against the JAX package, on the same
seeded numpy inputs, with exact equality: the fused two-choice build (its
planes bit-identical, "fused" and "auto" after a failed CHD placement) and
its probe, the minimizer bins on both feeds, the binary search over the
sorted planes, the classify step and the step with the device counters in
bsearch mode, a database value whose taxon is missing from the taxonomy, a
hierarchical run where one database falls back, and the goldens through
both fallbacks on both routes, with and without --device-counters.

Every test that makes a build fail copies the databases into tmp_path: a
load of tests/golden/data could find a cached table there and never fall
back."""

import dataclasses
import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krakenuniq_tpu.db.device_db as jax_device_db
import krakenuniq_tpu.db.hash_table as jax_hash_table
from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify import device_counters as JD
from krakenuniq_tpu.classify.device_step import _classify_and_count_core, classify_step
from krakenuniq_tpu.kmer import ops as jkops
from krakenuniq_tpu.lookup import lookup_kmers as jax_lookup_kmers
from krakenuniq_tpu.lookup.hash_lookup import _probe_fused as jax_probe_fused
from krakenuniq_tpu.lookup.hash_lookup import hash_lookup_kmers as jax_hash_lookup_kmers
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.classify import device_counters as TD
from krakenuniq_tpu_torch.classify.device_step import (
    StepConfig,
    classify_and_count_core,
    classify_step_core,
    kmer_bins,
    kmer_bins_plain,
    kmer_bins_sliding,
    kmer_bins_words,
    pack_input,
)
from krakenuniq_tpu_torch.db import device_db, hash_table
from krakenuniq_tpu_torch.db.device_db import build_device_db, device_db_from_host, load_database_dir
from krakenuniq_tpu_torch.db.hash_table import HashBuildError, build_hash_table
from krakenuniq_tpu_torch.formats import read_kdb, write_kdb
from krakenuniq_tpu_torch.formats.kdb import read_header
from krakenuniq_tpu_torch.formats.seqio import read_sequences
from krakenuniq_tpu_torch.kmer import encode_batch
from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, probe_fused_plain, probe_values
from krakenuniq_tpu_torch.lookup.xla_lookup import lookup_kmers, lookup_kmers_plain
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
T = torch.from_numpy
MISSING_TAXID = 987_654_321  # in no taxDB of the fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several pytest-xdist workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _copy_dbs(tmp_path, dbs=(".", "db_bact", "db_viral")):
    """The fixture databases' kdb, index, taxDB and counts under tmp_path."""
    for d in dbs:
        os.makedirs(tmp_path / d, exist_ok=True)
        for name in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
            shutil.copy(os.path.join(DATA, d, name), tmp_path / d / name)
    return [str(tmp_path / d) for d in dbs]


def _fail_chd(monkeypatch):
    """CHD placement fails at every width in both packages ("auto" builds
    the fused layout)."""
    monkeypatch.setattr(hash_table, "_chd_place", lambda *a, **k: None)
    monkeypatch.setattr(jax_hash_table, "_chd_place", lambda *a, **k: None)


def _fail_build(monkeypatch, only_keys: int | None = None):
    """The whole table build raises HashBuildError in both packages (for
    every database, or only for the one with `only_keys` keys)."""
    for mod, error in ((device_db, HashBuildError), (jax_device_db, jax_hash_table.HashBuildError)):
        real = mod.build_hash_table

        def boom(keys, *a, _real=real, _error=error, **k):
            if only_keys is None or len(keys) == only_keys:
                raise _error("synthetic failure")
            return _real(keys, *a, **k)

        monkeypatch.setattr(mod, "build_hash_table", boom)


def _keys_vals(rng, n, vmax=1 << 20):
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    return keys, rng.integers(1, vmax, size=len(keys)).astype(np.int32)


# ------------------------------------------------------------- fused build


@pytest.mark.parametrize("n", [10, 1000, 50000])
@pytest.mark.parametrize("layout", ["fused", "auto-fallback", "auto"])
def test_build_and_lookup_matches_jax(rng, monkeypatch, n, layout):
    """After tests/test_hash_lookup.py::test_build_and_lookup: the fused
    planes (pinned, or "auto" after CHD placement failed) are bit-identical
    to the JAX package's; every layout answers each key with its value and
    misses junk, as the JAX lookup does on its own planes."""
    keys, vals_dense = _keys_vals(rng, n)
    if layout == "auto-fallback":
        _fail_chd(monkeypatch)
    pinned = "fused" if layout == "fused" else "auto"
    _, j_lb, j_host = jax_hash_table.build_hash_table(
        keys, vals_dense.astype(np.uint32), vals_dense, keep_host=True, to_device=False, layout=pinned
    )
    host, lb = build_hash_table(keys, vals_dense, layout=pinned)
    if layout == "auto":
        assert len(host) == 2 and len(j_host) == 2  # CHD, placed by each package's own search
    else:
        assert lb == j_lb and len(host) == len(j_host) == 1
        np.testing.assert_array_equal(host[0], j_host[0])
    junk = rng.integers(0, 1 << 62, size=2000, dtype=np.uint64)
    junk = junk[~np.isin(junk, keys)]
    h = murmur3_finalizer(np.concatenate([keys, junk]))
    valid = rng.random(len(h)) < 0.9
    db = device_db_from_host(host, lb, None, k=31, nt=12, device="cpu")
    got = hash_lookup_kmers(db.hash_table, T(h.view(np.int64)), T(valid)).numpy()
    want = np.asarray(jax_hash_lookup_kmers(tuple(jnp.asarray(p) for p in j_host), jnp.asarray(h),
                                            jnp.asarray(valid), j_lb))
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got[: len(keys)], np.where(valid[: len(keys)], vals_dense, 0))
    np.testing.assert_array_equal(probe_values(db.hash_table, T(h[: len(keys)].view(np.int64))).numpy(),
                                  vals_dense)


# (keys, force_lb): the default width, a table at load 0.85, the smallest table
PROBE_CASES = {"default": (5000, None), "load085": (6963, 12), "lb4": (20, 4)}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_fused_matches_jax(case):
    """probe_fused_plain against the JAX package's _probe_fused on the same
    fused planes (both packages build them bit-identically, or both raise
    at a forced width): keys, junk, and queries whose tag and spare bits
    are zero (they match an empty all-zero slot and read value 0)."""
    n, force_lb = PROBE_CASES[case]
    rng = np.random.default_rng(n)
    vmax = 1 << 20 if force_lb is None else 1 << (force_lb - 1)
    keys, vals = _keys_vals(rng, n, vmax)
    try:
        _, j_lb, j_host = jax_hash_table.build_hash_table(
            keys, vals.astype(np.uint32), vals, force_lb=force_lb, keep_host=True, to_device=False,
            layout="fused",
        )
    except jax_hash_table.HashBuildError:
        with pytest.raises(HashBuildError):
            build_hash_table(keys, vals, force_lr=force_lb, layout="fused")
        return
    host, lb = build_hash_table(keys, vals, force_lr=force_lb, layout="fused")
    assert lb == j_lb == (force_lb or lb)
    np.testing.assert_array_equal(host[0], j_host[0])
    if case == "load085":
        assert len(keys) / (2 << lb) > 0.84
    zero_tag = rng.integers(0, 1 << lb, size=64, dtype=np.uint64) << np.uint64(64 - lb)
    h = np.concatenate([murmur3_finalizer(keys), rng.integers(0, 1 << 64, 500, dtype=np.uint64), zero_tag])
    found, val = probe_fused_plain(T(host[0].view(np.int32)), T(h.view(np.int64)), lb)
    j_found, j_val = jax_probe_fused(jnp.asarray(j_host[0]), jnp.asarray(h), j_lb)
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val).astype(np.int64))
    np.testing.assert_array_equal(val.numpy()[: len(keys)], vals)
    assert found.numpy()[-64:].any() and (val.numpy()[-64:] == 0).all()


def test_fused_force_width_refuses_wide_values(rng):
    keys, vals = _keys_vals(rng, 100, 1 << 10)
    vals[0] = 1 << 10
    with pytest.raises(ValueError):
        build_hash_table(keys, vals, force_lr=10, layout="fused")
    with pytest.raises(ValueError):
        build_hash_table(keys, vals, layout="two-level")


# ---------------------------------------------------------- minimizer bins


def _codes(seed, b=48, lb=160):
    """Random reads of varied lengths with ambiguous bases, as encode_batch
    lays them out (the padding and the N bases are ambiguous)."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(b):
        s = rng.choice(list("ACGT"), size=int(rng.integers(0, lb + 1)))
        s[rng.random(len(s)) < 0.03] = "N"
        seqs.append("".join(s))
    enc = encode_batch(seqs, lb=lb, batch=b)
    return enc.codes, enc.ambig


# the phase-2 shapes, w = 1 (nt = k), nt = 1 and the kernel's 8-byte values
# (nt > 16)
BIN_WIDTHS = [(21, 7), (31, 12), (31, 15), (31, 31), (31, 1), (31, 20)]


@pytest.mark.parametrize("feed", ["codes", "words"])
@pytest.mark.parametrize("k,nt", BIN_WIDTHS)
def test_kmer_bins_match_jax_minimizers(feed, k, nt):
    codes, ambig = _codes(k * nt)
    want_canon = np.asarray(jkops.canonical_representation(jkops.pack_windows(jnp.asarray(codes), k), k))
    want_bins = np.asarray(jkops.minimizers(jnp.asarray(codes), k, nt))
    if feed == "codes":
        canon, bins = kmer_bins(T(codes), k, nt)
    else:
        canon, bins = kmer_bins_words(pack_input(T(codes), T(ambig))[0], k, nt)
    np.testing.assert_array_equal(canon.numpy().view(np.uint64), want_canon)
    np.testing.assert_array_equal(bins.numpy().view(np.uint64), want_bins)
    assert (bins.numpy() < 4 ** nt).all()
    plain = kmer_bins_plain(T(codes), k, nt)
    assert all(torch.equal(a, b) for a, b in zip(plain, (canon, bins)))


@pytest.mark.parametrize("feed", ["codes", "words"])
@pytest.mark.parametrize("k,nt", BIN_WIDTHS)
def test_kmer_bins_sliding_matches_jax_minimizers(feed, k, nt):
    """The `kmer_bins` kernel's algorithm (kmer_bins_sliding: one nt-mer a
    base position, then the van Herk/Gil-Werman minimum) equals the JAX
    package's minimizers, with reads shorter than k, at rows of 160 bases
    and of 45 (codes, packed with padding) or 64 (words): lanes a row that w
    divides only where w = 1."""
    for lb in (160, 45 if feed == "codes" else 64):
        codes, ambig = _codes(k * nt + lb, lb=lb)
        words = pack_input(T(codes), T(ambig))[0]
        canon, bins = kmer_bins_sliding(words, lb, k, nt)
        want_bins = np.asarray(jkops.minimizers(jnp.asarray(codes), k, nt))
        want_canon = np.asarray(jkops.canonical_representation(jkops.pack_windows(jnp.asarray(codes), k), k))
        np.testing.assert_array_equal(bins.numpy().view(np.uint64), want_bins, err_msg=f"LB={lb}")
        np.testing.assert_array_equal(canon.numpy().view(np.uint64), want_canon, err_msg=f"LB={lb}")


# ---------------------------------------------------------- binary search


def _sorted_planes(rng, n_bins=4 ** 5):
    sizes = np.where(rng.random(n_bins) < 0.2, 0, rng.geometric(0.2, n_bins))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    keys = np.sort(rng.integers(0, 1 << 62, int(offsets[-1]), dtype=np.uint64))
    vals = rng.integers(0, 1 << 32, len(keys), dtype=np.uint64).astype(np.uint32)
    vals_dense = rng.integers(0, 1 << 20, len(keys)).astype(np.int32)
    return keys, vals, vals_dense, offsets, sizes


@pytest.mark.parametrize("bin_start", [0, 37])
def test_lookup_kmers_matches_jax(bin_start):
    """lookup_kmers_plain (and the wrapper on CPU tensors) against the JAX
    package's lookup_kmers on a shard's planes: keys and junk queries,
    bins out of range on both sides, empty bins, invalid lanes."""
    rng = np.random.default_rng(bin_start)
    keys, vals, vals_dense, offsets, sizes = _sorted_planes(rng)
    n_bins = len(sizes)
    bin_of = np.repeat(np.arange(n_bins), sizes)
    m = 6000
    pick = rng.integers(0, len(keys), m)
    q, bins = keys[pick].copy(), bin_of[pick].astype(np.uint64)
    junk = rng.random(m) < 0.3
    q[junk] = rng.integers(0, 1 << 62, int(junk.sum()), dtype=np.uint64)
    bins[:20] = np.uint64(n_bins + 3)  # past the last bin
    bins[20:40] = rng.choice(np.flatnonzero(sizes == 0), 20)
    if bin_start:
        bins[40:60] = rng.integers(0, bin_start, 20)  # below the shard's first bin
    valid = rng.random(m) >= 0.05
    k0 = int(offsets[bin_start])
    shard = (keys[k0:], vals[k0:], vals_dense[k0:], offsets[bin_start:] - k0)
    n_iter = max(1, int(np.ceil(np.log2(sizes.max() + 1))) + 1)
    j_t, j_td = jax_lookup_kmers(*(jnp.asarray(a) for a in shard), jnp.asarray(q), jnp.asarray(bins),
                                 jnp.asarray(valid), n_iter, bin_start)
    planes = (T(shard[0].view(np.int64)), T(shard[1].view(np.int32)), T(shard[2]), T(shard[3]))
    args = (*planes, T(q.view(np.int64)), T(bins.view(np.int64)), T(valid), n_iter, bin_start)
    t, td = lookup_kmers_plain(*args)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j_t))
    np.testing.assert_array_equal(td.numpy(), np.asarray(j_td))
    assert all(torch.equal(a, b) for a, b in zip(lookup_kmers(*args), (t, td)))
    hit = (t.numpy() != 0) | (td.numpy() != 0)
    assert hit.sum() > m // 3 and not hit[:40].any()


@pytest.mark.parametrize("value_pool", [True, False])
def test_matches_bsearch_on_golden(value_pool):
    """After tests/test_hash_lookup.py::test_matches_bsearch_on_golden: the
    binary search over the golden database's sorted planes and its hash
    table agree on every lane of 64 reads, and equal the JAX search."""
    db, tax = load_database_dir(DATA, device="cpu", pool="auto" if value_pool else None)
    reads = [d.seq for d in read_sequences(os.path.join(DATA, "reads.fa"))][:64]
    enc = encode_batch(reads, lb=256, batch=64)
    canon, bins = kmer_bins(T(enc.codes), db.k, db.nt)
    valid = ~T(np.array(jkops.window_any(jnp.asarray(enc.ambig), db.k)))
    t, td = lookup_kmers(*db.upload_sorted_planes("cpu"), canon, bins, valid, db.search_iters, 0)
    w = hash_lookup_kmers(db.hash_table, T(murmur3_finalizer(canon.numpy().view(np.uint64)).view(np.int64)),
                          valid).numpy()
    if db.pool is not None:
        np.testing.assert_array_equal(td.numpy(), db.pool.rows[w].astype(np.int32))
        np.testing.assert_array_equal(t.numpy().view(np.uint32), db.pool.taxids.astype(np.uint32)[w])
    else:
        np.testing.assert_array_equal(td.numpy(), w)
        np.testing.assert_array_equal(t.numpy().view(np.uint32), tax.taxids.astype(np.uint32)[w])
    assert (w != 0).sum() > 100
    j_t, j_td = jax_lookup_kmers(jnp.asarray(db.keys), jnp.asarray(db.vals), jnp.asarray(db.vals_dense),
                                 jnp.asarray(db.offsets), jnp.asarray(canon.numpy().view(np.uint64)),
                                 jnp.asarray(bins.numpy().view(np.uint64)), jnp.asarray(valid.numpy()),
                                 db.search_iters, 0)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j_t))
    np.testing.assert_array_equal(td.numpy(), np.asarray(j_td))


@pytest.mark.parametrize("how", ["build-fails", "cached", "chd-fails"])
def test_build_device_db(monkeypatch, rng, how):
    """After tests/test_hash_lookup.py::test_bsearch_fallback_on_hash_failure:
    a failed build keeps the sorted planes on the device, drops the pool
    and answers every key; a failed CHD placement builds the fused table;
    a cached table is uploaded as given, without a build."""
    from krakenuniq_tpu_torch.taxonomy import Taxonomy

    if how == "build-fails":
        _fail_build(monkeypatch)
    if how == "chd-fails":
        _fail_chd(monkeypatch)
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    keys = np.sort(np.unique(rng.integers(0, 1 << 62, size=500, dtype=np.uint64)))
    vals = rng.choice(tax.taxids[1:], size=len(keys)).astype(np.uint32)
    offsets = np.array([0, len(keys)], dtype=np.int64)
    cached = None
    if how == "cached":
        pool = device_db.build_value_pool([tax.dense_index(vals)], tax)
        cached = build_hash_table(keys, pool.pool_index(tax.dense_index(vals)))
        monkeypatch.setattr(device_db, "build_hash_table", None)  # a call would raise
    db = build_device_db(keys, vals, offsets, k=31, nt=0, taxonomy=tax, device="cpu", cached_hash=cached)
    h = T(murmur3_finalizer(keys).view(np.int64))
    if how != "build-fails":
        assert len(db.hash_table) == (1 if how == "chd-fails" else 2)
        assert db.pool is not None and db.sorted_planes is None
        assert ("build" in db.timings) == (how != "cached")
        if how == "cached":
            assert all(np.array_equal(p.numpy().view(np.uint32), c) for p, c in zip(db.hash_table, cached[0]))
        np.testing.assert_array_equal(probe_values(db.hash_table, h).numpy(), db.pool.pool_index(db.vals_dense))
        return
    assert db.hash_table is None and db.pool is None and db.max_bin == len(keys)
    sk, sv, svd, so = db.sorted_planes
    assert sk.dtype == torch.int64 and sv.dtype == torch.int32 and so.dtype == torch.int64
    t, td = lookup_kmers(*db.sorted_planes, T(keys.view(np.int64)), torch.zeros(len(keys), dtype=torch.int64),
                         torch.ones(len(keys), dtype=torch.bool), db.search_iters)
    np.testing.assert_array_equal(t.numpy().view(np.uint32), vals)
    np.testing.assert_array_equal(td.numpy(), tax.dense_index(vals))
    assert db.table_bytes == sum(p.numel() * p.element_size() for p in db.sorted_planes)


# ------------------------------------------------------------ the step


def _jax_bsearch(dbs, tmp_path, **opts):
    """A JAX Classifier on copies of `dbs` whose table builds all fail: its
    step searches the sorted planes in dense ids."""
    jc = JaxClassifier(_copy_dbs(tmp_path, dbs), JaxOptions(print_progress=False, use_native=False, **opts))
    assert jc._cfg.lookup_mode == "bsearch" and jc._pool is None
    return jc


def _port_planes(jc, missing=None):
    """The JAX Classifier's sorted planes as the port's bsearch planes (and
    the JAX planes), with `missing` value indices set to a taxid the
    taxonomy lacks (dense id 0)."""
    jplanes, planes = [], []
    for db in jc.dbs:
        keys, vals, vd, offs = (np.array(a) for a in (db.keys, db.vals, db.vals_dense, db.offsets))
        if missing is not None:
            vals[missing[missing < len(vals)]] = MISSING_TAXID
            vd[missing[missing < len(vd)]] = 0
        jplanes.append((jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(vd), jnp.asarray(offs), db.bin_start))
        planes.append((T(keys.view(np.int64)), T(vals.view(np.int32)), T(vd), T(offs), db.bin_start))
    return tuple(jplanes), tuple(planes)


def _step_feed(packed: bool):
    seqs = [d.seq for d in read_sequences(os.path.join(DATA, "reads.fa"))]
    seqs += ["", "ACGT" * 3, "N" * 40, "ACGTN" * 20]
    enc = encode_batch(seqs, lb=160, batch=160)
    if not packed:
        return (enc.codes, enc.ambig, enc.lengths), (T(enc.codes), T(enc.ambig), T(enc.lengths))
    cw, aw = pack_input(T(enc.codes), T(enc.ambig))
    return (cw.numpy().view(np.uint32), aw.numpy().view(np.uint32), enc.lengths), (cw, aw, T(enc.lengths))


def _same(got, want, key):
    """A port plane against a JAX one: unsigned planes compared by their
    bits (the port holds them in the signed type of the same width), the
    rest by value."""
    w = np.asarray(want)
    g = got.numpy()
    if w.dtype in (np.uint32, np.uint16, np.uint64):
        g = g.view(w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=key)


def _tables(jc):
    t = lambda a: T(np.array(a).view(np.int32))
    return (t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1), t(jc._parent),
            int(jc._root_dense))


# name: (databases, quick, packed span config, plant missing taxa)
STEP_CASES = {
    "plain": ((".",), False, False, False),
    "quick": ((".",), True, False, False),
    "hierarchical": (("db_bact", "db_viral"), False, False, False),
    "span": ((".",), False, True, False),
    "missing-taxon": ((".",), False, False, True),
    "missing-taxon-span": ((".",), False, True, True),
    # the span feed over two databases: one bsearch_words pass each, the
    # second only on the lanes the first left at 0
    "hierarchical-span": (("db_bact", "db_viral"), False, True, False),
    "missing-taxon-hierarchical-span": (("db_bact", "db_viral"), False, True, True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_bsearch_step_matches_jax(case, monkeypatch, tmp_path):
    """classify_step_core in bsearch mode against the JAX package's
    classify_step on the same sorted planes, every output equal; the
    missing-taxon cases plant values whose taxon is not in taxDB, which are
    hits under the stored taxid (dense id 0), as in the JAX bsearch
    branch."""
    dbs, quick, packed, missing = STEP_CASES[case]
    _fail_build(monkeypatch)
    jc = _jax_bsearch(dbs, tmp_path, quick=quick, min_hits=2 if quick else 1)
    idx = np.random.default_rng(3).choice(len(jc.dbs[0].keys), 300, replace=False) if missing else None
    jplanes, planes = _port_planes(jc, idx)
    jfeed, feed = _step_feed(packed)
    span = dict(packed_input=True, max_runs=8, dense_runs=True) if packed else {}
    jcfg = dataclasses.replace(jc._cfg, **span)
    want = classify_step(jplanes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense, *jfeed, jcfg)
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick,
                     min_hits=jc._cfg.min_hits, lookup_mode="bsearch", nt=jc.nt, n_iter=jc._cfg.n_iter, **span)
    got = classify_step_core(planes, *_tables(jc), *feed, cfg)
    assert set(got) == set(want)
    for key, w in want.items():
        _same(got[key], w, key)
    if missing:
        lanes = np.asarray(want["taxa"]) == MISSING_TAXID
        assert lanes.any() and (np.asarray(want["taxa_dense"])[lanes] == 0).all()


def test_bsearch_classify_and_count_matches_jax(monkeypatch, tmp_path):
    """classify_and_count_core in bsearch mode on a packed span against the
    JAX package's _classify_and_count_core: outputs, registers, counters
    and the sparse-stats buffer."""
    _fail_build(monkeypatch)
    jc = _jax_bsearch((".",), tmp_path)
    jplanes, planes = _port_planes(jc)
    jfeed, feed = _step_feed(True)
    b = feed[0].shape[0]
    n, bounds = 101, [0, 40, 101]
    unit_id = np.concatenate([np.repeat(np.arange(2, dtype=np.uint8), np.diff(bounds)),
                              np.full(b - n, 1, np.uint8)])
    p, cap = 12, 1 << 14
    pool_dense = np.unique(jc.dbs[0].vals_dense)
    outputs = ("packed", "taxa_dense", "ambig")
    jdc = JD.DeviceCounters(jc.taxonomy.size, p, pool_dense=pool_dense, sparse_cap=cap)
    tdc = TD.DeviceCounters(jc.taxonomy.size, p, pool_dense=pool_dense, sparse_cap=cap, device="cpu")
    jcfg = dataclasses.replace(jc._cfg, packed_input=True, max_runs=8, dense_runs=True, outputs=outputs)
    want_out, want_state, want_sp = _classify_and_count_core(
        *jdc.state(), jdc.pool_maps, jplanes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
        *jfeed, np.int32(n), jnp.asarray(unit_id), jcfg, p, jdc.sparse_cap, False, jdc.identity_pool,
    )
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, packed_input=True, max_runs=8,
                     dense_runs=True, outputs=outputs, lookup_mode="bsearch", nt=jc.nt, n_iter=jc._cfg.n_iter)
    got_out, got_sp = classify_and_count_core(*tdc.state(), tdc.lut, planes, *_tables(jc), *feed, n, T(unit_id),
                                              cfg, p, tdc.sparse_cap, False)
    for key in outputs:
        _same(got_out[key], want_out[key], key)
    for name, g, w in zip(("registers", "kmer_counts", "read_counts"), tdc.state(), want_state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got_sp[0].numpy().view(np.uint64), np.asarray(want_sp[0]))
    assert (int(got_sp[1]), int(got_sp[2])) == (int(want_sp[1]), int(want_sp[2])) and int(got_sp[1]) > 0


# ------------------------------------------------------- the Classifier


def _run(db_dirs, **opts):
    c = Classifier(list(db_dirs), ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([os.path.join(DATA, "reads.fa")], kraken_fh=kraken)
    c.write_report(report)
    return c, kraken.getvalue(), report.getvalue()


def _jax_run(db_dirs, **opts):
    jc = JaxClassifier(list(db_dirs), JaxOptions(print_progress=False, use_native=False, **opts))
    kraken, report = io.StringIO(), io.StringIO()
    jc.run([os.path.join(DATA, "reads.fa")], kraken_fh=kraken)
    jc.write_report(report)
    return jc, kraken.getvalue(), report.getvalue()


def test_missing_taxon_value_matches_jax(monkeypatch, tmp_path):
    """A database value whose taxon is missing from taxDB, through the
    binary-search fallback on the Python route: the JAX package counts such
    a k-mer as a hit under its stored taxid (device_step.py:209) and prints
    that taxid; the port gives the same bytes."""
    (d,) = _copy_dbs(tmp_path, (".",))
    hdr, keys, vals = read_kdb(os.path.join(d, "database.kdb"))
    vals = np.array(vals)
    vals[np.random.default_rng(5).choice(len(vals), 400, replace=False)] = MISSING_TAXID
    write_kdb(os.path.join(d, "database.kdb"), keys, vals, k=hdr.k)
    os.unlink(os.path.join(d, "database.kdb.counts"))
    _fail_build(monkeypatch)
    jc, j_kraken, j_report = _jax_run([d])
    assert jc._cfg.lookup_mode == "bsearch"
    os.unlink(os.path.join(d, "database.kdb.counts"))  # each package writes its own
    c, kraken, report = _run([d], use_native=False)
    assert c._cfg.lookup_mode == "bsearch" and c.route == "python"
    assert str(MISSING_TAXID) in kraken
    assert (kraken, report) == (j_kraken, j_report)


@pytest.mark.parametrize("route", ["span", "python"])
def test_mixed_hierarchical_fallback(route, monkeypatch, tmp_path):
    """db_viral's table build fails, db_bact's does not: the pools of a
    mixed run are dropped, every database is reloaded with dense ids and
    searched in its sorted planes (db_bact's uploaded for it), and the
    output is the goldens' and the JAX package's."""
    dirs = _copy_dbs(tmp_path, ("db_bact", "db_viral"))
    _fail_build(monkeypatch, only_keys=read_header(os.path.join(dirs[1], "database.kdb")).key_ct)
    c, kraken, report = _run(dirs, use_native=route == "span")
    assert c.route == route and c._cfg.lookup_mode == "bsearch" and c._pool is None
    bact, viral = c.dbs
    assert bact.hash_table is not None and viral.hash_table is None
    assert bact.sorted_planes is not None and viral.sorted_planes is not None
    assert (kraken, report) == (_golden("kraken_hier.out"), _golden("report_hier.tsv"))
    jc, j_kraken, j_report = _jax_run(dirs)
    assert jc._cfg.lookup_mode == "bsearch"
    assert (j_kraken, j_report) == (kraken, report)


# (fallback, databases, options); each run byte-equal to its goldens
GOLDEN_DBS = {"single": ((".",), "kraken.out", "report.tsv"),
              "hierarchical": (("db_bact", "db_viral"), "kraken_hier.out", "report_hier.tsv")}
GOLDEN_OPTS = {"span": {}, "python": {"use_native": False}, "span-counters": {"device_counters": True},
               "python-counters": {"device_counters": True, "use_native": False}}


@pytest.mark.parametrize("opts", sorted(GOLDEN_OPTS))
@pytest.mark.parametrize("dbs", sorted(GOLDEN_DBS))
@pytest.mark.parametrize("fallback", ["fused", "bsearch"])
def test_goldens_through_fallback(fallback, dbs, opts, monkeypatch, tmp_path):
    names, kraken_golden, report_golden = GOLDEN_DBS[dbs]
    if fallback == "fused":
        _fail_chd(monkeypatch)
    else:
        _fail_build(monkeypatch)
    c, kraken, report = _run(_copy_dbs(tmp_path, names), **GOLDEN_OPTS[opts])
    assert c.route == ("python" if "python" in opts else "span")
    if fallback == "fused":
        assert c._cfg.lookup_mode == "hash" and all(len(db.hash_table) == 1 for db in c.dbs)
    else:
        assert c._cfg.lookup_mode == "bsearch" and all(db.hash_table is None for db in c.dbs)
    assert (kraken, report) == (_golden(kraken_golden), _golden(report_golden))
