"""The port's data x db mesh (krakenuniq_tpu_torch.parallel) on the CPU,
after the JAX package's tests/test_parallel.py: the partitioner and the
sharded host planes (sorted planes, CHD and raw hash tables) bit-equal to
the JAX package's on the same numpy inputs, the sharded step on spawned
gloo ranks equal to the JAX package's single-device step, and the mesh
Classifier byte-equal to the port's single-device run and to the reference
binaries' goldens (tolerance 0). Where the JAX test uses 8 virtual devices
these use at most 4 ranks (each rank is a process): (2,4) -> (2,2),
(1,8) -> (1,4), (8,1) -> (4,1), (4,2) -> (2,1)."""

import functools
import io
import os

import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import StepConfig as JaxStepConfig
from krakenuniq_tpu.classify.device_step import classify_step
from krakenuniq_tpu.db import load_database_dir as jax_load_database_dir
from krakenuniq_tpu.parallel import partition as jax_partition
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.classify.device_step import StepConfig, pack_input
from krakenuniq_tpu_torch.formats import read_index, read_kdb
from krakenuniq_tpu_torch.formats.seqio import read_fasta
from krakenuniq_tpu_torch.kmer import encode_batch
from krakenuniq_tpu_torch.parallel import partition
from krakenuniq_tpu_torch.parallel.mesh import run_mesh, sharded_step_rank, spawn_mesh

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
READS = os.path.join(DATA, "reads.fa")
MESH_TIMEOUT = 240  # seconds: a hung rank fails its test

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "kraken.out")), reason="golden fixture missing"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, and so for the
    ranks it spawns (they share the caller's threads): the suite runs in
    several pytest-xdist workers on one host, whose torch thread pools
    would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    with open(READS) as f:
        reads = [d.seq for d in read_fasta(f)][:64]
    return encode_batch(reads, lb=256, batch=64)


def _host_db(kdb="database.kdb"):
    hdr, keys, vals = read_kdb(os.path.join(DATA, kdb))
    _, nt, offsets = read_index(os.path.join(DATA, "database.idx"))
    return np.asarray(keys), np.asarray(vals), np.asarray(offsets, dtype=np.int64), hdr.k, nt


def test_partitioner_matches_jax():
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 50, size=1000)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.uint64)
    for n in (1, 2, 3, 4, 8):
        bounds = partition.partition_bins_equal_keys(offsets, n)
        assert bounds == jax_partition.partition_bins_equal_keys(offsets, n)
        assert bounds[0][0] == 0 and bounds[-1][1] == 1000
        assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
        for lo, hi in bounds:
            assert int(offsets[hi] - offsets[lo]) <= int(offsets[-1]) // n + 50


@pytest.mark.parametrize("n", [2, 4])
def test_shard_db_planes_match_jax(n):
    jdb, _ = jax_load_database_dir(DATA)
    args = (np.asarray(jdb.keys), np.asarray(jdb.vals), np.asarray(jdb.vals_dense), np.asarray(jdb.offsets), n)
    got, want = partition.shard_db_planes(*args), jax_partition.shard_db_planes(*args)
    for f in ("keys", "vals", "vals_dense", "offsets", "bin_start"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.max_bin == want.max_bin and got.n_shards == n


@pytest.mark.parametrize("raw", [False, True], ids=["chd", "raw"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_hash_tables_match_jax(n, raw):
    """The stacked host planes of every shard bit-equal to the JAX package's
    (its hash_sink), and a rank's own build of one shard equal to its slice."""
    keys, vals, offsets, _, _ = _host_db("uid_database.kdb" if raw else "database.kdb")
    if raw:
        table_vals = np.zeros(len(vals), np.int32)
    else:
        jdb, _ = jax_load_database_dir(DATA)
        table_vals = jdb.pool.pool_index(np.asarray(jdb.vals_dense)) if jdb.pool is not None else np.asarray(
            jdb.vals_dense)
    sink_j, sink_t = [], []
    jax_partition.shard_hash_tables(keys, vals, table_vals, offsets, n, hash_sink=sink_j, store_raw=raw)
    sp = partition.shard_hash_tables(keys, vals, table_vals, offsets, n, hash_sink=sink_t, store_raw=raw)
    (want, lb_j, bounds_j), (got, lb_t, bounds_t) = sink_j[0], sink_t[0]
    assert (lb_t, bounds_t) == (lb_j, bounds_j) and sp.lb == lb_j and sp.store_raw == raw
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape[0] == n
        np.testing.assert_array_equal(g, np.asarray(w))
    one = partition.shard_hash_tables(keys, vals, table_vals, offsets, n, store_raw=raw, shards=[n - 1])
    assert one.planes[:-1] == [None] * (n - 1) and one.lb == lb_j
    for g, w in zip(one.planes[-1], want):
        np.testing.assert_array_equal(g, np.asarray(w)[n - 1])
    with pytest.raises(ValueError):
        one.stacked()


def test_shard_hash_tables_restart_agrees():
    """A shard whose placement stalls at the common width restarts every
    shard one bit wider; `any_failed` (the mesh's db-group vote) makes a
    rank that built its own shard fine restart with the others."""
    keys, vals, offsets, _, _ = _host_db()
    jdb, _ = jax_load_database_dir(DATA)
    table_vals = np.asarray(jdb.vals_dense)
    base = partition.shard_hash_tables(keys, vals, table_vals, offsets, 2, shards=[0])
    votes = iter([True, False])
    wider = partition.shard_hash_tables(keys, vals, table_vals, offsets, 2, shards=[0],
                                        any_failed=lambda failed: next(votes) or failed)
    assert wider.lb == base.lb + 1 and wider.planes[0][1].shape[0] == 2 * base.planes[0][1].shape[0]


def _tables(jc):
    t = lambda a: np.asarray(a).view(np.int32)  # noqa: E731
    return (t(jc._taxid_table), np.stack([t(jc._tin), t(jc._tout)], axis=1), t(jc._parent), int(jc._root_dense))


def _check_outputs(got, want):
    for key in ("taxa", "ambig", "call", "hits", "enc", "hll_lanes"):
        g, w = got[key], np.asarray(want[key])
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_bsearch():
    """The JAX single-device binary-search step on the batch, its inputs."""
    jdb, tax = jax_load_database_dir(DATA)
    enc = _batch()
    root = np.int32(tax.dense_index(np.asarray([1], dtype=np.uint32))[0])
    jcfg = JaxStepConfig(k=jdb.k, nt=jdb.nt, n_iter=jdb.search_iters, max_depth=tax.max_depth)
    want = classify_step(((jdb.keys, jdb.vals, jdb.vals_dense, jdb.offsets, 0),), tax.taxids.astype(np.uint32),
                         tax.tin, tax.tout, tax.parent, root, enc.codes, enc.ambig, enc.lengths, jcfg)
    tables = (tax.taxids.astype(np.uint32).view(np.int32), np.stack([tax.tin, tax.tout], axis=1).astype(np.int32),
              tax.parent.astype(np.int32), int(root))
    return jdb, tax, enc, tables, {k: np.asarray(v) for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _jax_hash():
    """The JAX single-device hash step on the batch, its inputs."""
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False))
    assert jc._cfg.lookup_mode == "hash"
    enc = _batch()
    want = classify_step(jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
                         enc.codes, enc.ambig, enc.lengths, jc._cfg)
    return jc, enc, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n_data,n_db,packed", [(2, 2, False), (1, 4, False), (4, 1, False), (2, 1, False),
                                                (2, 2, True)])
def test_sharded_bsearch_equals_single(n_data, n_db, packed):
    """The binary search over minimizer-sharded sorted planes (JAX
    test_sharded_equals_single), on the unpacked feed and on the span
    route's packed words (`bsearch_words`: each shard's words merge before
    they fill the lanes still 0)."""
    jdb, tax, enc, tables, want = _jax_bsearch()
    planes = partition.shard_db_planes(np.asarray(jdb.keys), np.asarray(jdb.vals), np.asarray(jdb.vals_dense),
                                       np.asarray(jdb.offsets), n_db)
    cfg = StepConfig(k=jdb.k, max_depth=tax.max_depth, lookup_mode="bsearch", nt=jdb.nt,
                     n_iter=jdb.search_iters, packed_input=packed)
    feed = (enc.codes, enc.ambig, enc.lengths)
    if packed:
        words = pack_input(torch.from_numpy(enc.codes), torch.from_numpy(enc.ambig))
        feed = (words[0].numpy(), words[1].numpy(), enc.lengths)
    got = spawn_mesh(sharded_step_rank, n_data, n_db, "cpu", args=(planes, tables, feed, cfg),
                     timeout=MESH_TIMEOUT)
    _check_outputs(got, want)


@pytest.mark.parametrize("n_data,n_db", [(2, 2), (1, 4)])
def test_sharded_hash_equals_single(n_data, n_db):
    """The CHD tables sharded by minimizer range (JAX
    test_hash_sharded_equals_single): each rank probes its shard, the words
    merge over its db group."""
    jc, enc, want = _jax_hash()
    keys, vals, offsets, _, _ = _host_db()
    planes = partition.shard_hash_tables(keys, vals, jc._pool.pool_index(np.asarray(jc.dbs[0].vals_dense)),
                                         offsets, n_db)
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p)
    got = spawn_mesh(sharded_step_rank, n_data, n_db, "cpu",
                     args=(planes, _tables(jc), (enc.codes, enc.ambig, enc.lengths), cfg), timeout=MESH_TIMEOUT)
    _check_outputs(got, want)


def _single(dbs, reads=READS, uid=False, **kw):
    c = Classifier(dbs, ClassifyOptions(device="cpu", print_progress=False, **kw), uid_database=uid)
    out, rep = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=out)
    c.write_report(rep)
    return out.getvalue(), rep.getvalue()


@pytest.mark.parametrize("n_data,n_db", [(1, 2), (2, 1), (2, 2)])
def test_mesh_pipeline_matches_single_device(n_data, n_db):
    """The whole Classifier on a mesh of spawned ranks writes the bytes of
    the port's single-device run and of the reference binaries' goldens
    (JAX test_mesh_pipeline_matches_single_chip)."""
    out0, rep0 = _single([DATA])
    got = run_mesh([DATA], ClassifyOptions(device="cpu", print_progress=False, mesh_data=n_data, mesh_db=n_db),
                   [READS], timeout=MESH_TIMEOUT)
    assert got["kraken"] == out0
    assert got["report"] == rep0
    with open(os.path.join(DATA, "kraken.out")) as f:
        assert got["kraken"] == f.read()
    with open(os.path.join(DATA, "report.tsv")) as f:
        assert got["report"] == f.read()
    # the words of each database probe merged once a span over a db row
    assert (got["merge_calls"] > 0) == (n_db > 1)
