"""Out-of-core classification (--preload-size) in the port
(krakenuniq_tpu_torch) on the CPU, after the JAX package's
tests/test_outofcore.py: the chunk planner equals the JAX package's, each
chunk table answers exactly its own keys, the accumulating probe and the
"acc" finish step equal the JAX package's integer for integer on the JAX
package's own chunk tables, and the out-of-core Classifier and CLI write
what the resident run and the reference binaries' goldens hold, on both
routes, with and without device counters, double- and single-buffered,
over hierarchical databases, and writing nothing next to the database but
the port's chunk cache.
Every run forces a budget far below the table so the database streams in
at least three chunks."""

import dataclasses
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
from krakenuniq_tpu.db import chunked as jax_chunked
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions, pipeline
from krakenuniq_tpu_torch.classify.device_step import (
    StepConfig,
    classify_step_core,
    kmer_bins_plain,
    kmer_front_packed,
    pack_input,
    probe_chunk_core,
    unpack_input,
)
from krakenuniq_tpu_torch.cli.main import main as cli_main
from krakenuniq_tpu_torch.db import chunked
from krakenuniq_tpu_torch.db.hash_table import HashBuildError, build_hash_table
from krakenuniq_tpu_torch.formats import read_index, read_kdb
from krakenuniq_tpu_torch.formats.kdb import read_header
from krakenuniq_tpu_torch.lookup.hash_lookup import hash_lookup_plain
from krakenuniq_tpu_torch.taxonomy import Taxonomy
from krakenuniq_tpu_torch.utils.bits import murmur3_finalizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")
T = torch.from_numpy
SPAN_OUTPUTS = ("packed", "taxa_dense", "ambig", "hll_enc", "hll_dense")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several pytest-xdist workers on one host, whose torch thread pools
    would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _tiny_budget(db_dir, frac=4):
    """A budget that forces >= `frac`-way chunking of the db's table."""
    tax = Taxonomy.from_taxdb_file(os.path.join(db_dir, "taxDB"))
    hdr = read_header(os.path.join(db_dir, "database.kdb"))
    return max(1024, chunked.table_bytes(hdr.key_ct, tax.size - 1, False) // frac)


def _run(db_dirs, reads=READS, **opts):
    c = Classifier(list(db_dirs), ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue(), c


def _chunks_used(c):
    return sum(cdb.n_chunks for cdb in c._ooc) if c._ooc is not None else 0


# ----------------------------------------------------------------- planner


def _plan_case(seed):
    rng = np.random.default_rng(seed)
    n_bins = int(rng.integers(1, 400))
    sizes = rng.integers(0, 3000, size=n_bins)
    sizes[rng.random(n_bins) < 0.2] = 0  # empty bins
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    budget = int(rng.integers(256, 1 << 22))
    max_value = int(rng.integers(0, 70_000))
    return offsets, budget, max_value, bool(seed % 3 == 0), int(rng.integers(1, 4)), int(rng.integers(1, 5))


@pytest.mark.parametrize("seed", range(12))
def test_plan_chunks_matches_jax(seed):
    offsets, budget, max_value, raw, min_chunks, multiple = _plan_case(seed)
    args = (offsets, budget, max_value, raw, min_chunks, multiple)
    try:
        want = jax_chunked.plan_chunks(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            chunked.plan_chunks(*args)
        assert str(got.value) == str(e)
        return
    bounds, lb = chunked.plan_chunks(*args)
    assert (bounds, lb) == want
    assert len(bounds) % multiple == 0 and len(bounds) >= min_chunks
    assert bounds[0][0] == 0 and bounds[-1][1] == len(offsets) - 1
    assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("raw", [False, True], ids=["chd", "raw"])
def test_table_bytes_matches_jax(raw):
    for n in (0, 1, 2, 100, 4096, 10**5, 1234567, 110_988_000):
        for max_value in (0, 502, 65_535, 2_400_502):
            assert chunked.table_bytes(n, max_value, raw) == jax_chunked.table_bytes(n, max_value, raw)


@pytest.mark.parametrize(
    "offsets,budget,match",
    [(np.array([0, 100_000]), 64, "below the minimum chunk table"),
     (np.array([0, 10, 100_000]), 64 << 10, "largest minimizer bin")],
    ids=["budget-too-small", "largest-bin"],
)
def test_plan_chunks_refuses(offsets, budget, match):
    with pytest.raises(ValueError, match=match):
        chunked.plan_chunks(offsets, budget, max_value=100, store_raw=False)
    with pytest.raises(ValueError, match=match):
        jax_chunked.plan_chunks(offsets, budget, max_value=100, store_raw=False)


@pytest.mark.parametrize(
    "n,vmax,lr,error",
    [(100, 5, 4, HashBuildError), (100, 1 << 9, 8, ValueError)],
    ids=["stall", "value-width"],
)
def test_build_at_forced_width_raises(n, vmax, lr, error):
    """A forced width is never grown: a stall raises HashBuildError (the
    chunked build restarts on it), a value past it raises ValueError."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    vals = rng.integers(1, vmax + 1, size=len(keys)).astype(np.uint32)
    vals[0] = vmax
    with pytest.raises(error):
        build_hash_table(keys, vals, force_lr=lr)
    _, free_lr = build_hash_table(keys, vals)  # the default call grows instead
    assert free_lr >= max(lr, 4)


def test_chunk_tables_need_bounds():
    """Chunk tables without their bin ranges are refused: the passes route
    lanes by them, and probing every lane instead is not an option."""
    planes = [(np.zeros((4, 4), np.uint32), np.zeros((16, 4), np.uint32))] * 2
    with pytest.raises(ValueError, match="minimizer-bin range"):
        chunked.chunked_db_from_planes(planes, 4, 31, 9)
    with pytest.raises(ValueError, match="minimizer-bin range"):
        chunked.chunked_db_from_planes(planes, 4, 31, 9, [(0, 7)])


# ----------------------------------------------------------- chunk tables


@pytest.mark.parametrize("db", [".", "db_bact", "db_viral"])
def test_chunk_tables_answer_their_own_keys(db):
    d = os.path.join(DATA, db)
    tax = Taxonomy.from_taxdb_file(os.path.join(d, "taxDB"))
    cdb = chunked.load_chunked_db(d, _tiny_budget(d), tax)
    assert cdb.n_chunks >= 3 and cdb.pool is not None
    _, keys, _ = read_kdb(os.path.join(d, "database.kdb"))
    _, _, offsets = read_index(os.path.join(d, "database.idx"))
    want = cdb.pool.pool_index(cdb.vals_dense)
    h = T(murmur3_finalizer(np.asarray(keys)).view(np.int64))
    valid = torch.ones(len(keys), dtype=torch.bool)
    owned = np.zeros(len(keys), np.int64)
    for ci, (lo, hi) in enumerate(cdb.bounds):
        mine = np.zeros(len(keys), bool)
        mine[int(offsets[lo]) : int(offsets[hi])] = True
        owned += mine
        got = hash_lookup_plain(cdb.chunk_planes[ci], h, valid).numpy()
        np.testing.assert_array_equal(got[mine], want[mine])
        assert not got[~mine].any(), f"chunk {ci} answers another chunk's key"
        assert cdb.chunk_planes[ci][1].shape == (1 << cdb.lb, 4)
    assert (owned == 1).all()  # the chunks tile the key set


# ------------------------------------------ the probe and the finish vs JAX


@pytest.fixture(scope="module")
def jax_chunks():
    """The JAX package's resident Classifier on the golden database and the
    JAX package's own chunk tables of it, carried into the port."""
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False))
    hdr, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    _, nt, offsets = read_index(os.path.join(DATA, "database.idx"))
    vd = jc.taxonomy.dense_index(vals)
    jcdb = jax_chunked.build_chunked_db(
        keys, vals, jc._pool.pool_index(vd), offsets, _tiny_budget(DATA), hdr.k, nt,
    )
    assert jcdb.n_chunks >= 3
    planes = [tuple(np.asarray(p) for p in cp) for cp in jcdb.chunk_planes]
    cdb = chunked.chunked_db_from_planes(planes, jcdb.lb, hdr.k, nt, jcdb.bounds, len(keys))
    return jc, jcdb, cdb


def _span_feed(lb=160, b=192):
    """The golden reads plus an empty read, one shorter than k, an all-N one
    and an N-riddled one, bit-packed by the port's native module."""
    with open(READS, "rb") as f:
        buf = f.read() + b">e\n\n>s\nACGTACGTACGT\n>n\n" + b"N" * 40 + b"\n>m\n" + b"ACGTN" * 20 + b"\n"
    nat = _native_build.native()
    n, offs, _ = nat.parse_unit(buf, False)
    return nat.encode_unit_packed(buf, np.ascontiguousarray(offs), lb, b)


def _feed(packed):
    """(numpy feed for JAX, torch feed for the port) in either layout."""
    codes, ambig, lengths = _span_feed()
    if packed:
        return (codes, ambig, lengths), (T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths))
    c, a = unpack_input(T(codes.view(np.int32)), T(ambig.view(np.int32)))
    return (c.numpy(), a.numpy(), lengths), (c, a, T(lengths))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_probe_chunk_core_matches_jax(jax_chunks, packed):
    """Pass by pass, the routed pass (only the lanes whose bin the chunk
    owns are probed) equals the JAX package's probe of every lane; the
    JAX side takes either feed, the port the packed one (pack_input packs
    the unpacked feed, as the Python route does)."""
    jc, jcdb, cdb = jax_chunks
    (jcodes, jambig, jlen), feed = _feed(packed)
    if not packed:
        feed = (*pack_input(feed[0], feed[1]), feed[2])
    w = feed[0].shape[1] * 16 - jc.k + 1
    rng = np.random.default_rng(5)
    acc0 = np.where(rng.random((feed[0].shape[0], w)) < 0.5, rng.integers(1, 30, size=(feed[0].shape[0], w)), 0)
    acc_j = jnp.asarray(acc0.astype(np.uint32))
    acc_t = T(acc0.astype(np.int32))
    jcfg = JaxStepConfig(k=jc.k, nt=jc.nt, n_iter=1, max_depth=jc._cfg.max_depth, lookup_mode="hash",
                         hash_lbs=(jcdb.lb,), raw_dbs=(False,), packed_input=packed)
    filled = []
    for ci in range(cdb.n_chunks):
        acc_j = _probe_chunk_core(acc_j, tuple(jnp.asarray(p) for p in jcdb.chunk_planes[ci]),
                                  jcodes, jambig, jlen, jcfg)
        before = int((acc_t != 0).sum())
        out = probe_chunk_core(acc_t, cdb.chunk_planes[ci], cdb.bounds[ci], *feed, jc.k, cdb.nt)
        assert out is acc_t  # in place
        np.testing.assert_array_equal(acc_t.numpy().view(np.uint32), np.asarray(acc_j), err_msg=f"chunk {ci}")
        filled.append(int((acc_t != 0).sum()) - before)
    assert all(f > 0 for f in filled)  # every chunk filled lanes


def _searched(feed, k):
    """(canonical k-mers, search mask) of a packed span feed."""
    codes, ambig, lengths = feed
    lb = 16 * codes.shape[1]
    canon, _ = kmer_bins_plain(unpack_input(codes, ambig)[0], k, 1)
    _, _, kmer_ambig = kmer_front_packed(codes, ambig, lb, k, 0)
    pos = torch.arange(lb - k + 1)[None, :]
    return canon, (pos < torch.clamp(lengths - (k - 1), min=0)[:, None]) & ~kmer_ambig


def test_chunk_ranges_route_every_lane_once(jax_chunks):
    """The chunks' bin ranges tile the bins: each searched lane falls in
    exactly one chunk's range, and where the lane's k-mer is a key, that
    chunk's table holds it with the key's value; every other chunk misses
    the lane, which is why skipping them leaves acc as it was."""
    jc, jcdb, cdb = jax_chunks
    _, feed = _feed(True)
    canon, search = _searched(feed, jc.k)
    bins = kmer_bins_plain(unpack_input(feed[0], feed[1])[0], jc.k, cdb.nt)[1]
    owners = sum(((bins >= lo) & (bins < hi)).long() for lo, hi in cdb.bounds)
    assert bool((owners[search] == 1).all())
    _, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    table_vals = jc._pool.pool_index(jc.taxonomy.dense_index(vals))
    kmers = canon.numpy().view(np.uint64)
    order = np.argsort(keys)
    at = order[np.minimum(np.searchsorted(keys[order], kmers), len(keys) - 1)]
    is_key = torch.from_numpy(keys[at] == kmers) & search
    want = T(np.where(is_key.numpy(), table_vals[at], 0).astype(np.int32))
    assert int(is_key.sum()) > 100 and bool((want[is_key] != 0).all())
    hashes = T(murmur3_finalizer(kmers).view(np.int64))
    for ci, (lo, hi) in enumerate(cdb.bounds):
        mine = search & (bins >= lo) & (bins < hi)
        got = hash_lookup_plain(cdb.chunk_planes[ci], hashes, search)
        assert torch.equal(got[mine], want[mine]), f"chunk {ci} differs on its own lanes"
        assert not bool(got[search & ~mine].any()), f"chunk {ci} answers a lane it does not own"


def test_probe_chunk_core_hierarchy_of_two_nt(tmp_path):
    """Two databases of different minimizer lengths, probed in database
    order, each chunk routed by its own database's nt and bounds: the first
    (nt = 7, six genomes) and the second (nt = 9, the same six genomes and
    six more, values from 1000). Pass by pass equal to the JAX package's
    probe of every lane; the first database's word wins on every k-mer it
    holds, and the second's genomes hit through its own routing."""
    from krakenuniq_tpu_torch.utils.demo import make_demo_db, make_demo_reads

    dbs = []
    for n_species, nt, base in ((6, 7, 1), (12, 9, 1000)):
        keys, _, offsets, _, genomes = make_demo_db(n_species=n_species, genome_len=3000, k=31, nt=nt)
        values = (np.arange(len(keys)) % 500 + base).astype(np.int32)
        budget = chunked.table_bytes(len(keys), int(values.max()), False) // 3
        jcdb = jax_chunked.build_chunked_db(keys, values, values, offsets, budget, 31, nt)
        planes = [tuple(np.asarray(p) for p in cp) for cp in jcdb.chunk_planes]
        dbs.append((jcdb, chunked.chunked_db_from_planes(planes, jcdb.lb, 31, nt, jcdb.bounds, len(keys)), keys))
    assert all(c.n_chunks >= 2 for _, c, _ in dbs)
    reads = make_demo_reads(genomes, 80, seed=1)
    path = tmp_path / "r.fa"
    path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    buf = path.read_bytes()
    nat = _native_build.native()
    _, offs, _ = nat.parse_unit(buf, False)
    codes, ambig, lengths = nat.encode_unit_packed(buf, np.ascontiguousarray(offs), 160, 96)
    feed = (T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths))
    jcfg = JaxStepConfig(k=31, nt=7, n_iter=1, max_depth=8, lookup_mode="hash", hash_lbs=(0,), raw_dbs=(False,),
                         packed_input=True)
    acc_j = jnp.zeros((feed[0].shape[0], 160 - 30), dtype=jnp.uint32)
    acc_t = torch.zeros(acc_j.shape, dtype=torch.int32)
    for jcdb, cdb, _ in dbs:
        for ci in range(cdb.n_chunks):
            acc_j = _probe_chunk_core(acc_j, tuple(jnp.asarray(p) for p in jcdb.chunk_planes[ci]), codes, ambig,
                                      lengths, dataclasses.replace(jcfg, hash_lbs=(jcdb.lb,)))
            probe_chunk_core(acc_t, cdb.chunk_planes[ci], cdb.bounds[ci], *feed, 31, cdb.nt)
            np.testing.assert_array_equal(acc_t.numpy().view(np.uint32), np.asarray(acc_j),
                                          err_msg=f"nt {cdb.nt} chunk {ci}")
    canon, search = _searched(feed, 31)
    in_first = search.numpy() & np.isin(canon.numpy().view(np.uint64), dbs[0][2])
    got = acc_t.numpy()
    assert in_first.sum() > 100 and ((got[in_first] > 0) & (got[in_first] < 1000)).all()
    assert (got[search.numpy() & ~in_first] >= 1000).sum() > 100


@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_acc_step_matches_jax(jax_chunks, quick):
    """The finish step on the merged word plane (lookup_mode "acc") equals
    the JAX step in "acc" mode for every output of the span config."""
    jc, jcdb, cdb = jax_chunks
    (codes, ambig, lengths), feed = _feed(True)
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick, min_hits=2 if quick else 1,
                     packed_input=True, max_runs=8, dense_runs=True, outputs=SPAN_OUTPUTS)
    acc = torch.zeros((feed[0].shape[0], 16 * feed[0].shape[1] - jc.k + 1), dtype=torch.int32)
    for ci in range(cdb.n_chunks):
        probe_chunk_core(acc, cdb.chunk_planes[ci], cdb.bounds[ci], *feed, jc.k, cdb.nt)
    jcfg = dataclasses.replace(
        jc._cfg, packed_input=True, max_runs=8, dense_runs=True, outputs=SPAN_OUTPUTS, quick=quick,
        min_hits=2 if quick else 1, lookup_mode="acc", hash_lbs=(), raw_dbs=(False,), n_iter=1,
    )
    want = classify_step(jnp.asarray(acc.numpy().view(np.uint32)), jc._taxid_table, jc._tin, jc._tout,
                         jc._parent, jc._root_dense, codes, ambig, lengths, jcfg)
    t = lambda a: T(np.array(a).view(np.int32))
    got = classify_step_core(
        acc, t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1), t(jc._parent),
        int(jc._root_dense), *feed, dataclasses.replace(cfg, lookup_mode="acc"),
    )
    assert tuple(got) == SPAN_OUTPUTS
    for key in SPAN_OUTPUTS:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)
    assert (np.asarray(want["packed"])[:, :8] != 0).any()


# ------------------------------------------------------ the Classifier


@pytest.fixture(scope="module")
def budget():
    return _tiny_budget(DATA)


MODES = {
    "default": ({}, ("kraken.out", "report.tsv")),
    "quick": ({"quick": True, "min_hits": 2}, ("kraken_quick.out", None)),
    "device_counters": ({"device_counters": True}, ("kraken.out", "report.tsv")),
}


@pytest.mark.parametrize("route", ["span", "python"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ooc_matches_resident_and_golden(budget, mode, route):
    opts, (kraken_gold, report_gold) = MODES[mode]
    opts = {**opts, "use_native": route == "span"}
    out0, rep0, c0 = _run([DATA], **opts)
    out1, rep1, c1 = _run([DATA], preload_size=budget, **opts)
    assert c0._ooc is None and c1._ooc is not None and _chunks_used(c1) >= 3
    assert c1.route == route and c1.dbs == [] and c1._db_planes is None
    assert c1._cfg.lookup_mode == "acc" and c1._cfg_packed.lookup_mode == "acc"
    assert (c1.n_spans > 0) == (route == "span") and c1.ooc_groups >= 1
    assert out1 == out0 and rep1 == rep0
    assert out1 == _golden(kraken_gold)
    if report_gold:
        assert rep1 == _golden(report_gold)


def test_ooc_groups_of_one_span(budget, monkeypatch):
    """ooc_group_bytes=1: every span is its own group (one pass of the chunk
    tables each), over many small spans and work units."""
    for name, value in {"WORK_UNIT_SIZE": 1500, "SPAN_READS": 40, "MAX_RUNS": 2}.items():
        monkeypatch.setattr(pipeline, name, value)
    out0, rep0, c0 = _run([DATA])
    out1, rep1, c1 = _run([DATA], preload_size=budget, ooc_group_bytes=1)
    out2, rep2, c2 = _run([DATA], preload_size=budget)
    assert c1.n_spans >= 4 and c1.ooc_groups == c1.n_spans and c2.ooc_groups == 1
    assert out1 == out0 == out2 and rep1 == rep0 == rep2
    assert out1 == _golden("kraken.out")


@pytest.mark.parametrize("double", [True, False], ids=["double-buffered", "single-buffered"])
def test_ooc_buffering(budget, double):
    out, rep, c = _run([DATA], preload_size=budget, ooc_double_buffer=double)
    assert _chunks_used(c) >= 3
    assert c._ooc_prefetch == double
    if double:
        assert 2 * c._ooc[0].chunk_bytes() <= budget
    else:
        assert c._ooc[0].chunk_bytes() <= budget < 2 * c._ooc[0].chunk_bytes()
    assert out == _golden("kraken.out") and rep == _golden("report.tsv")
    # the same chunk set single-buffered through one slot
    shared = Classifier.with_shared_db(c, ooc_double_buffer=False)
    assert shared._ooc is c._ooc and shared._ooc_slots is c._ooc_slots and not shared._ooc_prefetch
    kraken = io.StringIO()
    shared.run([READS], kraken_fh=kraken)
    assert kraken.getvalue() == out


def test_ooc_shared_state(budget):
    c = _run([DATA], preload_size=budget)[2]
    dc = Classifier.with_shared_db(c, device_counters=True)
    kraken, report = io.StringIO(), io.StringIO()
    dc.run([READS], kraken_fh=kraken)
    dc.write_report(report)
    assert kraken.getvalue() == _golden("kraken.out") and report.getvalue() == _golden("report.tsv")
    resident = _run([DATA])[2]
    with pytest.raises(ValueError, match="resident DB state into out-of-core"):
        Classifier.with_shared_db(resident, preload_size=budget)


@pytest.mark.parametrize("order", [("db_bact", "db_viral"), ("db_viral", "db_bact")], ids=["bact-viral", "viral-bact"])
def test_ooc_hierarchical(order):
    """Chunks are probed in database order, so the first nonzero word is
    the first database's hit (classify.cpp:927-936)."""
    dbs = [os.path.join(DATA, d) for d in order]
    budget = max(_tiny_budget(d, frac=2) for d in dbs)
    out0, rep0, _ = _run(dbs)
    out1, rep1, c1 = _run(dbs, preload_size=budget)
    assert len(c1._ooc) == 2 and _chunks_used(c1) >= 3
    assert c1._ooc[0].pool is c1._ooc[1].pool is not None  # one joint id space
    assert out1 == out0 == _golden("kraken_hier.out")
    assert rep1 == rep0 == _golden("report_hier.tsv")


# ----------------------------------------- the resident-or-stream decision


@pytest.fixture(scope="module")
def demo_70k(tmp_path_factory):
    """A demo database over a taxonomy of about 70,000 nodes (past u16),
    small enough that its pooled table (16 value bits) is half its dense
    one (17 bits)."""
    from krakenuniq_tpu_torch.formats import write_index, write_kdb
    from krakenuniq_tpu_torch.utils.demo import make_demo_db, make_demo_reads

    td = str(tmp_path_factory.mktemp("demo70k"))
    keys, vals, offsets, tax, genomes = make_demo_db(n_species=16, genome_len=5000, k=31, nt=9, pad_nodes=70_000)
    write_kdb(os.path.join(td, "database.kdb"), keys, vals, k=31)
    write_index(os.path.join(td, "database.idx"), 9, np.asarray(offsets, dtype=np.uint64))
    tax.write_taxdb(os.path.join(td, "taxDB"))
    reads = make_demo_reads(genomes, n_reads=300)
    path = os.path.join(td, "reads.fa")
    with open(path, "w") as f:
        f.writelines(f">r{i}\n{r}\n" for i, r in enumerate(reads))
    return td, path


@pytest.mark.parametrize("case", ["pool-builds", "pool-fails", "no-pool"])
def test_ambiguous_budget(demo_70k, case, monkeypatch):
    """Between the pooled and the dense estimate the database stays resident
    if and only if the value pool builds; with value_pool=False it streams
    and the span route takes the per-span taxon dictionary."""
    db, reads = demo_70k
    c0 = Classifier([db], ClassifyOptions(print_progress=False, device="cpu"))
    assert c0.taxonomy.size > 0xFFFF
    pooled, dense = c0._estimate_table_bytes(pooled=True), c0._estimate_table_bytes(pooled=False)
    assert pooled < dense
    ps = (pooled + dense) // 2
    if case == "pool-fails":
        monkeypatch.setattr(pipeline, "build_value_pool", lambda *a, **k: None)
    out, rep, c = _run([db], reads, preload_size=ps, value_pool=case != "no-pool")
    out0, rep0, _ = _run([db], reads, value_pool=False)
    assert (c._ooc is None) == (case == "pool-builds")
    if c._ooc is not None:
        assert c._pool is None and c._cfg_packed.local_dict and _chunks_used(c) >= 2
    assert out == out0 and rep == rep0


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("size,streams", [("34K", True), ("0.04M", True), ("1G", False)])
def test_cli_preload_size(tmp_path, capsys, size, streams):
    out, rep = tmp_path / "k.out", tmp_path / "r.tsv"
    rc = cli_main(["--device", "cpu", "--db", DATA, "--preload-size", size, "--output", str(out),
                   "--report-file", str(rep), READS])
    assert rc == 0
    assert ("out-of-core:" in capsys.readouterr().err) == streams
    assert out.read_text() == _golden("kraken.out")
    # the report carries a provenance header before the golden rows
    assert rep.read_text().split("\n", 2)[2] == _golden("report.tsv")


def test_cli_bad_preload_size(capsys):
    assert cli_main(["--device", "cpu", "--db", DATA, "--preload-size", "12Q", READS]) == 1
    assert "bad --preload-size value '12Q'" in capsys.readouterr().err


def test_ooc_writes_only_its_chunk_cache(tmp_path, budget):
    """The out-of-core run adds exactly the port's chunk cache
    (database.kdb.htc_torch) beside the database and changes no other file;
    a second run reads it ("cache": "hit", no build) and leaves its bytes as
    they were."""
    for name in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
        shutil.copy(os.path.join(DATA, name), tmp_path / name)
    before = {n: (tmp_path / n).read_bytes() for n in os.listdir(tmp_path)}
    out, rep, c = _run([str(tmp_path)], preload_size=budget)
    assert _chunks_used(c) >= 3 and out == _golden("kraken.out") and rep == _golden("report.tsv")
    assert c._ooc[0].timings["cache"] == "miss"
    assert sorted(os.listdir(tmp_path)) == sorted([*before, "database.kdb.htc_torch"])
    assert all((tmp_path / n).read_bytes() == b for n, b in before.items())
    cache = (tmp_path / "database.kdb.htc_torch").read_bytes()
    out, rep, c2 = _run([str(tmp_path)], preload_size=budget)
    assert out == _golden("kraken.out") and rep == _golden("report.tsv")
    assert c2._ooc[0].timings["cache"] == "hit" and "build" not in c2._ooc[0].timings
    assert (tmp_path / "database.kdb.htc_torch").read_bytes() == cache
    assert sorted(os.listdir(tmp_path)) == sorted([*before, "database.kdb.htc_torch"])
