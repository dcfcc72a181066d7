"""UID databases (--uid-mapping) in the port (krakenuniq_tpu_torch) on the
CPU against the JAX package, with exact equality: the raw two-level table
build (planes bit-equal to the JAX build's), its plain probe
(probe_rows_plain) against the JAX `_probe_rows` on the probe's edge cases,
the step with a raw database (`raw_dbs`) in "hash" and "acc" modes on both
feeds, the out-of-core pass over raw chunk tables, and every route of the
Classifier and the CLI against the golden `kraken_uid.out` and the JAX
Classifier's reports: span and Python routes, --device-counters, out of
core, long reads, the refusals, and the port's table caches of
`uid_database.kdb`. The JAX runs are cached per module."""

import dataclasses
import functools
import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import StepConfig as JaxStepConfig
from krakenuniq_tpu.classify.device_step import _probe_chunk_core, classify_step
from krakenuniq_tpu.cli.main import main as jax_cli_main
from krakenuniq_tpu.db import chunked as jax_chunked
from krakenuniq_tpu.db.hash_table import build_hash_table as jax_build_hash_table
from krakenuniq_tpu.lookup.hash_lookup import _probe_rows as jax_probe_rows
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.classify.device_step import StepConfig, classify_step_core, probe_chunk_core
from krakenuniq_tpu_torch.cli.main import main as cli_main
from krakenuniq_tpu_torch.db import chunked
from krakenuniq_tpu_torch.db.device_db import device_db_from_host, load_database_dir
from krakenuniq_tpu_torch.db.hash_table import GOLDEN, _self_check, build_hash_table
from krakenuniq_tpu_torch.formats import read_index, read_kdb
from krakenuniq_tpu_torch.formats.kdb import read_header
from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_kmers, probe_rows_plain, probe_values
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")
UID_KDB = os.path.join(DATA, "uid_database.kdb")
T = torch.from_numpy
STEP_KEYS = ("taxa", "taxa_dense", "call", "packed", "hll_pairs", "hits", "n_kmers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _run(reads=READS, db=DATA, **opts):
    c = Classifier([db], ClassifyOptions(print_progress=False, device="cpu", **opts), uid_database=True)
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue(), c


@functools.lru_cache(maxsize=None)
def _jax_run_cached(reads, opts):
    c = JaxClassifier([DATA], JaxOptions(print_progress=False, **dict(opts)), uid_database=True)
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue()


def _jax_run(reads=READS, **opts):
    """The JAX Classifier's kraken output and report under UID (cached)."""
    return _jax_run_cached(reads, tuple(sorted(opts.items())))


def _tiny_budget():
    """A budget that cuts the raw table into at least four chunk tables."""
    return chunked.table_bytes(read_header(UID_KDB).key_ct, 0, True) // 4


# ------------------------------------------------------ the two-level build


def _random_raw(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    vals = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)  # full 32-bit words
    return keys, vals


@pytest.mark.parametrize("source", ["golden", "random-1000", "random-30000"])
def test_two_level_build_matches_jax(source):
    """build_hash_table(store_raw=True) gives the JAX build's planes bit for
    bit ((ptags [2^lb, 2], confirm [2^(lb+1), 2]) at the load factor's
    width), and every key probes back to its raw value."""
    if source == "golden":
        _, keys, vals = read_kdb(UID_KDB)
    else:
        keys, vals = _random_raw(int(source.split("-")[1]), 3)
    planes, lb = build_hash_table(keys, vals, store_raw=True)
    _, j_lb, j_planes = jax_build_hash_table(keys, vals, np.zeros(len(keys), np.int32), store_raw=True,
                                             to_device=False, keep_host=True)
    assert lb == j_lb
    assert [p.shape for p in planes] == [(1 << lb, 2), (2 << lb, 2)]
    for got, want in zip(planes, j_planes):
        np.testing.assert_array_equal(got, want)
    h = murmur3_finalizer(np.asarray(keys, np.uint64))
    assert _self_check(planes, h, np.asarray(vals, np.uint32), lb) == 0
    got = probe_values(tuple(T(p.view(np.int32)) for p in planes), T(h.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), vals)


def test_two_level_build_forced_width():
    """A raw table at a forced width takes any value (the two-level layout
    has no value field to overflow), as the chunk tables need."""
    keys, vals = _random_raw(500, 5)
    vals[0] = 0xFFFFFFFF
    planes, lb = build_hash_table(keys, vals, store_raw=True, force_lr=12, layout="chd")
    _, j_lb, j_planes = jax_build_hash_table(keys, vals, np.zeros(len(keys), np.int32), store_raw=True,
                                             force_lb=12, to_device=False, keep_host=True, layout="chd")
    assert lb == j_lb == 12
    for got, want in zip(planes, j_planes):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- the plain probe


def _edge_planes(lb, seed):
    """Random two-level planes (every word random, as a loaded table's
    neighbours look to a query) with the probe's cases planted, and the
    queries: planted keys in either bucket and slot, misses, keys whose two
    buckets coincide, zero-tag keys behind an empty slot 0 (stored in slot
    1: the probe confirms slot 0 and misses), and keys in their second
    bucket behind a first bucket that screens them falsely (a miss too)."""
    with np.errstate(over="ignore"):  # uint64 products wrap, as the hash's do
        rng = np.random.default_rng(seed)
        nb = 1 << lb
        ptags = rng.integers(0, 1 << 32, size=(nb, 2), dtype=np.uint64).astype(np.uint32)
        confirm = rng.integers(0, 1 << 32, size=(2 * nb, 2), dtype=np.uint64).astype(np.uint32)
        shift = np.uint64(64 - lb)
        tag = lambda x: ((x << np.uint64(lb)) >> np.uint64(32)).astype(np.uint32)  # noqa: E731
        lo = lambda x: (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)  # noqa: E731
        h = rng.integers(0, 1 << 64, size=4000, dtype=np.uint64)
        planted = h[:1000]
        for i, x in enumerate(planted):
            choice, slot = i % 2, (i // 2) % 2
            xc = x * GOLDEN if choice else x
            b = int(xc >> shift)
            ptags[b, slot] = tag(xc)
            confirm[2 * b + slot] = (lo(x), i + 1)
        cand = rng.integers(0, 1 << 64, size=1 << min(24, lb + 6), dtype=np.uint64)
        same = cand[(cand >> shift) == ((cand * GOLDEN) >> shift)][:40]
        for i, x in enumerate(same):
            b = int(x >> shift)
            ptags[b, i % 2] = tag(x)
            confirm[2 * b + i % 2] = (lo(x), 5000 + i)
        zero_tag = (rng.integers(0, nb, size=64, dtype=np.uint64) << shift) | rng.integers(
            1, 1 << (32 - lb), size=64, dtype=np.uint64)
        for i, x in enumerate(zero_tag):
            b = int(x >> shift)
            ptags[b] = 0
            confirm[2 * b] = 0
            confirm[2 * b + 1] = (lo(x), 6000 + i)
        screen = h[1000:1064]
        for i, x in enumerate(screen):
            b1, b2 = int(x >> shift), int((x * GOLDEN) >> shift)
            ptags[b1, 0] = tag(x)
            confirm[2 * b1] = (lo(x) ^ np.uint32(1), 7000 + i)
            ptags[b2, 1] = tag(x * GOLDEN)
            confirm[2 * b2 + 1] = (lo(x), 8000 + i)
        queries = np.concatenate([h, same, zero_tag, screen])  # (later plants may overwrite earlier ones)
        return (ptags, confirm), queries, (len(h), len(same), len(zero_tag), len(screen))


@pytest.mark.parametrize("lb", [8, 14, 20])
def test_probe_rows_plain_matches_jax(lb):
    """probe_rows_plain equals _probe_rows (found and value) on every case,
    and, on planes wide enough that the plants seldom overwrite each other,
    the cases behave as the first-screened-slot rule says."""
    (ptags, confirm), q, (n_h, n_same, n_zero, n_screen) = _edge_planes(lb, lb)
    found, val = probe_rows_plain(T(ptags.view(np.int32)), T(confirm.view(np.int32)), T(q.view(np.int64)), lb)
    j_found, j_val = jax_probe_rows(jnp.asarray(ptags), jnp.asarray(confirm), jnp.asarray(q), lb)
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(val.numpy().astype(np.uint32)[found.numpy()], np.asarray(j_val)[found.numpy()])
    got = np.where(found.numpy(), val.numpy(), 0)
    s0 = n_h + n_same
    assert len(q) - s0 == n_zero + n_screen and n_same > 0
    assert (got[:1000] > 0).any() and (got[1000:n_h] == 0).mean() > 0.99  # planted keys, misses
    if lb >= 14:
        assert (got[:1000] > 0).mean() > 0.95 and (got[n_h:s0] >= 5000).mean() > 0.9  # coinciding buckets
        assert (got[s0:] == 0).mean() > 0.95  # zero tags behind an empty slot, false screens: misses


def test_hash_lookup_raw_on_cpu():
    """hash_lookup_kmers on raw planes (CPU tensors: the plain version)
    keeps the value words as int32 bit patterns, 0 on invalid lanes, and
    probe_values equals it with every lane valid."""
    (ptags, confirm), q, _ = _edge_planes(12, 1)
    planes = (T(ptags.view(np.int32)), T(confirm.view(np.int32)))
    h = T(q[: len(q) // 4 * 4].view(np.int64)).reshape(-1, 4)
    valid = torch.rand(h.shape, generator=torch.Generator().manual_seed(0)) < 0.7
    got = hash_lookup_kmers(planes, h, valid)
    assert got.dtype == torch.int32 and got.shape == h.shape
    assert not got[~valid].any()
    np.testing.assert_array_equal(got[valid].numpy(), probe_values(planes, h)[valid].numpy())


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def jax_uid():
    """The JAX package's resident UID Classifier on the golden database."""
    return JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False), uid_database=True)


def _span_feed(lb=160, b=192):
    """The golden reads plus an empty read, one shorter than k, an all-N one
    and an N-riddled one, bit-packed by the port's native module."""
    with open(READS, "rb") as f:
        buf = f.read() + b">e\n\n>s\nACGTACGTACGT\n>n\n" + b"N" * 40 + b"\n>m\n" + b"ACGTN" * 20 + b"\n"
    nat = _native_build.native()
    _, offs, _ = nat.parse_unit(buf, False)
    return nat.encode_unit_packed(buf, np.ascontiguousarray(offs), lb, b)


def _feeds(packed):
    """(numpy feed for JAX, torch feed for the port) in either layout."""
    from krakenuniq_tpu_torch.classify.device_step import unpack_input

    codes, ambig, lengths = _span_feed()
    if packed:
        return (codes, ambig, lengths), (T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths))
    c, a = unpack_input(T(codes.view(np.int32)), T(ambig.view(np.int32)))
    return (c.numpy(), a.numpy(), lengths), (c, a, T(lengths))


def _tables(jc):
    t = lambda a: T(np.array(a).view(np.int32))  # noqa: E731
    return t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1), t(jc._parent), int(jc._root_dense)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("mode", ["hash", "acc"])
def test_step_raw_matches_jax(jax_uid, mode, packed):
    """classify_step_core with raw_dbs=(True,) equals the JAX step on the
    raw plane, the dense plane, the calls, the wide rows of raw ids, the u64
    HLL feed, the hit counts and the k-mer counts; "hash" probes the raw
    table, "acc" reads a merged word plane of raw words (full 32-bit words
    among them)."""
    jc = jax_uid
    jfeed, feed = _feeds(packed)
    b = jfeed[0].shape[0]
    w = (16 * jfeed[0].shape[1] if packed else jfeed[0].shape[1]) - jc.k + 1
    jcfg = dataclasses.replace(jc._cfg, packed_input=packed, max_runs=8, dense_runs=False, outputs=STEP_KEYS,
                               lookup_mode=mode)
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, packed_input=packed, max_runs=8,
                     outputs=STEP_KEYS, lookup_mode=mode, raw_dbs=(True,))
    if mode == "hash":
        j_planes = jc._db_planes
        planes = (tuple(T(np.array(p).view(np.int32)) for p in jc._db_planes[0]),)
    else:
        rng = np.random.default_rng(7)
        words = np.where(rng.random((b, w)) < 0.5, rng.integers(1, 1 << 32, size=(b, w), dtype=np.uint64), 0)
        words[:, ::3] = np.minimum(words[:, ::3], 7)  # runs of the golden's small uids
        j_planes = jnp.asarray(words.astype(np.uint32))
        planes = T(words.astype(np.uint32).view(np.int32))
    want = classify_step(j_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense, *jfeed, jcfg)
    got = classify_step_core(planes, *_tables(jc), *feed, cfg)
    for key in STEP_KEYS:
        w_, g = np.asarray(want[key]), got[key].numpy()
        g = g.view(w_.dtype) if g.dtype.itemsize == w_.dtype.itemsize else g.astype(w_.dtype)  # bits, or counts
        np.testing.assert_array_equal(g, w_, err_msg=key)
    assert (np.asarray(want["taxa"]) != 0).any() and not np.asarray(want["taxa_dense"]).any()


def test_step_raw_counters_key_on_raw_plane(jax_uid):
    """classify_and_count_core under a raw database counts the k-mers under
    the raw ids (the "taxa" plane) and no read (n_valid = 0)."""
    from krakenuniq_tpu_torch.classify.device_step import classify_and_count_core

    jc = jax_uid
    _, feed = _feeds(True)
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=12, packed_input=True, max_runs=8,
                     outputs=("packed", "taxa"), raw_dbs=(True,))
    planes = (tuple(T(np.array(p).view(np.int32)) for p in jc._db_planes[0]),)
    n = 9
    reg = torch.zeros((n, 1 << 12), dtype=torch.uint8)
    kmer_counts, read_counts = torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64)
    out, _ = classify_and_count_core(reg, kmer_counts, read_counts, None, planes, *_tables(jc), *feed, 0, None,
                                     cfg, 12)
    step = classify_step_core(planes, *_tables(jc), *feed, dataclasses.replace(cfg, outputs=("taxa", "hll_lanes")))
    want = torch.bincount(step["taxa"][step["hll_lanes"]].long(), minlength=n)
    np.testing.assert_array_equal(kmer_counts.numpy(), want.numpy())
    assert not read_counts.any() and torch.equal(out["taxa"], step["taxa"])


# -------------------------------------------------------- the out-of-core pass


@pytest.fixture(scope="module")
def raw_chunks():
    """The JAX package's raw chunk tables of uid_database.kdb at a quarter
    of the table, carried into the port (chunked_db_from_planes)."""
    hdr, keys, vals = read_kdb(UID_KDB)
    _, nt, offsets = read_index(os.path.join(DATA, "database.idx"))
    jcdb = jax_chunked.build_chunked_db(keys, vals, np.zeros(len(vals), np.int32), offsets, _tiny_budget(), hdr.k,
                                        nt, store_raw=True)
    assert jcdb.n_chunks >= 3
    planes = [tuple(np.asarray(p) for p in cp) for cp in jcdb.chunk_planes]
    cdb = chunked.chunked_db_from_planes(planes, jcdb.lb, hdr.k, nt, jcdb.bounds, len(keys))
    return jcdb, cdb, hdr.k


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_probe_chunk_core_raw_matches_jax(raw_chunks, packed):
    """Pass by pass over the raw chunk tables, the routed pass equals the
    JAX package's probe of every lane (JAX on either feed, the port on the
    packed one), from a word plane half set with raw words."""
    from krakenuniq_tpu_torch.classify.device_step import pack_input

    jcdb, cdb, k = raw_chunks
    assert cdb.store_raw and cdb.chunk_planes[0][0].shape == (1 << cdb.lb, 2)
    (jcodes, jambig, jlen), feed = _feeds(packed)
    if not packed:
        feed = (*pack_input(feed[0], feed[1]), feed[2])
    w = 16 * feed[0].shape[1] - k + 1
    rng = np.random.default_rng(11)
    acc0 = np.where(rng.random((feed[0].shape[0], w)) < 0.5, rng.integers(1, 1 << 32, size=(feed[0].shape[0], w),
                                                                          dtype=np.uint64), 0).astype(np.uint32)
    acc_j, acc_t = jnp.asarray(acc0), T(acc0.view(np.int32).copy())
    jcfg = JaxStepConfig(k=k, nt=cdb.nt, n_iter=1, max_depth=8, lookup_mode="hash", hash_lbs=(jcdb.lb,),
                         raw_dbs=(True,), packed_input=packed)
    filled = 0
    for ci in range(cdb.n_chunks):
        acc_j = _probe_chunk_core(acc_j, tuple(jnp.asarray(p) for p in jcdb.chunk_planes[ci]), jcodes, jambig, jlen,
                                  jcfg)
        before = int((acc_t != 0).sum())
        assert probe_chunk_core(acc_t, cdb.chunk_planes[ci], cdb.bounds[ci], *feed, k, cdb.nt) is acc_t
        np.testing.assert_array_equal(acc_t.numpy().view(np.uint32), np.asarray(acc_j), err_msg=f"chunk {ci}")
        filled += int((acc_t != 0).sum()) - before
    assert filled > 0


def test_raw_chunk_planes_refused_when_malformed():
    """Raw chunk planes whose confirm plane is not twice the tag plane, or a
    set mixing layouts, are refused; chunk tables need their bin ranges."""
    raw = (np.zeros((16, 2), np.uint32), np.zeros((32, 2), np.uint32))
    cdb = chunked.chunked_db_from_planes([raw, raw], 4, 31, 9, [(0, 3), (3, 9)])
    assert cdb.store_raw and cdb.n_chunks == 2
    with pytest.raises(ValueError, match="neither CHD nor raw"):
        chunked.chunked_db_from_planes([(raw[0], raw[0])], 4, 31, 9, [(0, 3)])
    with pytest.raises(ValueError, match="neither CHD nor raw"):
        chunked.chunked_db_from_planes([raw, (np.zeros((4, 4), np.uint32), np.zeros((16, 4), np.uint32))], 4, 31,
                                       9, [(0, 3), (3, 9)])
    with pytest.raises(ValueError, match="minimizer-bin range"):
        chunked.chunked_db_from_planes([raw], 4, 31, 9)


def test_device_db_from_host_raw(jax_uid):
    """The JAX package's raw planes as a port DeviceDB: store_raw, no pool,
    and the table answers every key with its raw value."""
    host = tuple(np.asarray(p) for p in jax_uid.dbs[0].hash_table)
    db = device_db_from_host(host, jax_uid.dbs[0].hash_lb, None, k=31, nt=jax_uid.nt, device="cpu")
    assert db.store_raw and db.pool is None
    _, keys, vals = read_kdb(UID_KDB)
    got = probe_values(db.hash_table, T(murmur3_finalizer(np.asarray(keys)).view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), vals)


# ----------------------------------------------------------- the Classifier


@pytest.mark.parametrize("device_counters", [False, True], ids=["host", "device_counters"])
@pytest.mark.parametrize("route", ["span", "python"])
def test_uid_classify_matches_golden_and_jax(route, device_counters):
    """The port's counterpart of tests/test_uid.py::
    test_uid_classify_matches_reference and tests/test_device_counters.py::
    test_device_counters_uid_mode: kraken_uid.out byte for byte, and the
    report byte-equal to the JAX Classifier's, on either route, with the
    counters on the host or on the device."""
    out, rep, c = _run(use_native=route == "span", device_counters=device_counters)
    assert c.route == route and c._cfg.raw_dbs == (True,) and c.dbs[0].store_raw
    assert out == _golden("kraken_uid.out")
    assert rep == _jax_run(use_native=route == "span", device_counters=device_counters)[1]
    if device_counters:
        assert rep == _run(use_native=route == "span")[1]


@pytest.mark.parametrize("device_counters", [False, True], ids=["host", "device_counters"])
@pytest.mark.parametrize("route", ["span", "python"])
def test_uid_out_of_core(route, device_counters):
    """The port's counterpart of tests/test_outofcore.py::test_ooc_uid: at a
    quarter of the raw table the database streams in at least two raw chunk
    tables (rows_probe_acc's plain version), byte-equal to the resident run
    and to the golden."""
    kw = dict(use_native=route == "span", device_counters=device_counters)
    out, rep, c = _run(preload_size=_tiny_budget(), **kw)
    assert c._ooc is not None and c._ooc[0].n_chunks >= 2 and c._ooc[0].store_raw
    assert out == _golden("kraken_uid.out")
    assert (out, rep) == _run(**kw)[:2]


@pytest.fixture(scope="module")
def long_fa(tmp_path_factory):
    """reads.fa with the five library genomes (1.8-2.2 kbp) after it."""
    path = tmp_path_factory.mktemp("uid_long") / "mix.fa"
    with open(READS) as a, open(os.path.join(DATA, "library.fna")) as b:
        path.write_text(a.read() + b.read())
    return str(path)


@pytest.mark.parametrize("device_counters", [False, True], ids=["host", "device_counters"])
@pytest.mark.parametrize("route", ["span", "python"])
def test_uid_long_reads_match_jax(long_fa, route, device_counters):
    """Reads past max_read_len = 1024 take the long-read route under UID
    (chunks, the host's resolve_uids): output and report byte-equal to the
    JAX Classifier's."""
    kw = dict(use_native=route == "span", device_counters=device_counters, max_read_len=1024)
    out, rep, c = _run(long_fa, **kw)
    assert c.n_long_reads >= 4
    assert (out, rep) == _jax_run(long_fa, **kw)


@pytest.mark.parametrize("kw,message", [
    ({"opts": {"quick": True}}, "Quick mode not available when mapping UIDs"),
    ({"dbs": 2}, "Cannot use more than one database with UID mapping!"),
], ids=["quick", "two-databases"])
def test_uid_refusals(kw, message):
    """Both packages refuse quick mode and several databases under UID."""
    dbs = [DATA] * kw.get("dbs", 1)
    with pytest.raises(ValueError, match=message):
        Classifier(dbs, ClassifyOptions(print_progress=False, device="cpu", **kw.get("opts", {})), uid_database=True)
    with pytest.raises(ValueError, match=message):
        JaxClassifier(dbs, JaxOptions(print_progress=False, **kw.get("opts", {})), uid_database=True)


def test_with_shared_db_keeps_uid():
    """with_shared_db carries the UID database and map into new options."""
    _, _, c = _run()
    cd = Classifier.with_shared_db(c, device_counters=True)
    assert cd.uid_map is c.uid_map and cd._cfg.raw_dbs == (True,) and cd.dbs is c.dbs
    kraken = io.StringIO()
    cd.run([READS], kraken_fh=kraken)
    assert kraken.getvalue() == _golden("kraken_uid.out")


def test_cli_uid_mapping_matches_jax(tmp_path):
    """The CLI with --uid-mapping: kraken output byte-equal to the golden and
    to the JAX CLI's, the report body (after the provenance header)
    byte-equal to the JAX CLI's."""
    results = []
    for name, main, extra in (("port", cli_main, ["--device", "cpu"]), ("jax", jax_cli_main, [])):
        out, rep = tmp_path / f"{name}.out", tmp_path / f"{name}.tsv"
        assert main(["--db", DATA, *extra, "--uid-mapping", "--output", str(out), "--report-file", str(rep),
                     READS]) == 0
        lines = rep.read_text().splitlines(keepends=True)
        assert lines[0].startswith("# KrakenUniq-TPU") and lines[1].startswith("# CL:")
        results.append((out.read_text(), "".join(lines[2:])))
    assert results[0] == results[1]
    assert results[0][0] == _golden("kraken_uid.out")


# ------------------------------------------------------------ the caches


def _uid_copy(tmp_path):
    d = tmp_path / "db"
    d.mkdir()
    for f in ("uid_database.kdb", "uid_to_taxid.map", "database.idx", "taxDB", "database.kdb.counts"):
        shutil.copy(os.path.join(DATA, f), d / f)
    return str(d)


def test_uid_table_cache_round_trip(tmp_path):
    """A cold load writes uid_database.kdb.ht_dense_torch (its meta records
    store_raw); a warm load reads it, planes equal; a non-raw load of the
    same kdb would not take it."""
    from krakenuniq_tpu_torch.db.ht_cache import load_ht_cache

    d = _uid_copy(tmp_path)
    cold, _ = load_database_dir(d, device="cpu", uid_database=True)
    path = os.path.join(d, "uid_database.kdb.ht_dense_torch")
    assert cold.timings["cache"] == "miss" and os.path.exists(path) and cold.store_raw
    warm, _ = load_database_dir(d, device="cpu", uid_database=True)
    assert warm.timings["cache"] == "hit" and "build" not in warm.timings and warm.store_raw
    assert all(torch.equal(a, b) for a, b in zip(warm.hash_table, cold.hash_table))
    kdb, taxdb = os.path.join(d, "uid_database.kdb"), os.path.join(d, "taxDB")
    assert load_ht_cache(path, kdb, taxdb, store_raw=True) is not None
    assert load_ht_cache(path, kdb, taxdb, store_raw=False) is None
    assert sorted(os.listdir(d)) == sorted(["uid_database.kdb", "uid_to_taxid.map", "database.idx", "taxDB",
                                            "database.kdb.counts", "uid_database.kdb.ht_dense_torch"])


def test_uid_chunk_cache_round_trip(tmp_path):
    """Out of core, a cold load writes uid_database.kdb.htc_torch and a warm
    load reads the same raw chunk tables back; the run from the warm load
    is byte-equal to the golden."""
    d = _uid_copy(tmp_path)
    budget = _tiny_budget()
    cold = chunked.load_chunked_db(d, budget, None, uid_database=True)
    warm = chunked.load_chunked_db(d, budget, None, uid_database=True)
    assert cold.timings["cache"] == "miss" and warm.timings["cache"] == "hit"
    assert cold.store_raw and warm.store_raw and cold.bounds == warm.bounds and cold.lb == warm.lb
    for a, b in zip(cold.chunk_planes, warm.chunk_planes):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert os.path.exists(os.path.join(d, "uid_database.kdb.htc_torch"))
    out, _, c = _run(db=d, preload_size=2 * budget)  # double-buffered: planned at half of it
    assert c._ooc[0].timings["cache"] == "hit"
    assert out == _golden("kraken_uid.out")


# ------------------------------------- where the port departs from the JAX package


@pytest.mark.parametrize("route", ["span", "python"])
def test_uid_exact_matches_jax_python_route(route):
    """UID with --exact: the port's span and Python routes give the golden
    lines and the JAX Python route's report (the JAX span route raises on
    this option pair: ROADMAP §3, F6)."""
    out, rep, _ = _run(use_native=route == "span", exact=True)
    assert out == _golden("kraken_uid.out")
    assert rep == _jax_run(use_native=False, exact=True)[1]


@pytest.mark.parametrize("route", ["span", "python"])
def test_uid_binary_search_fallback(tmp_path, monkeypatch, route):
    """A UID database whose table build fails is searched in its sorted
    planes (the raw values) and still gives the golden lines on both routes
    (the JAX span route prints zeros in the hit lists there: ROADMAP §3,
    F7), with the report of the resident table."""
    from krakenuniq_tpu_torch.db import device_db, hash_table

    def fail(*a, **kw):
        raise hash_table.HashBuildError("build failure forced by the test")

    d = _uid_copy(tmp_path)
    monkeypatch.setattr(device_db, "build_hash_table", fail)
    out, rep, c = _run(db=d, use_native=route == "span")
    assert c._cfg.lookup_mode == "bsearch" and c._cfg.raw_dbs == (True,)
    assert out == _golden("kraken_uid.out")
    assert rep == _run(use_native=route == "span")[1]
