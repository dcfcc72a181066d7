"""The per-span taxon dictionary in the port (krakenuniq_tpu_torch) on the
CPU, after the JAX package's tests/test_local_dict.py: a taxonomy past the
u16 range with the real species at the largest dense ids and no value pool.
The span step under `local_dict` equals the JAX step (lut, rows, the u16
feed, a dictionary overflow included), and so do its wide rows and u64
feed; the span route (compact rows through the dictionary, the wide
redispatch at a tiny capacity, quick mode, device counters) writes what
the port's Python route writes."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import classify_step
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions, pipeline
from krakenuniq_tpu_torch.classify import device_step
from krakenuniq_tpu_torch.classify.device_step import (
    StepConfig, classify_step_core, span_dict, span_dict_bitmap, span_dict_plain,
)
from krakenuniq_tpu_torch.db.device_db import device_db_from_host

K, NT = 31, 9
PAD = 70_000  # taxonomy nodes beyond the u16 range
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several pytest-xdist workers on one host, whose torch thread pools
    would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big_tax_db(tmp_path_factory):
    from krakenuniq_tpu.formats import write_index, write_kdb
    from krakenuniq_tpu.utils.demo import make_demo_db, make_demo_reads

    td = tmp_path_factory.mktemp("bigtax_db_torch")
    keys, vals, offsets, tax, genomes = make_demo_db(
        n_species=50, genome_len=9000, k=K, nt=NT, species_base=10_000_000, pad_nodes=PAD,
    )
    assert tax.size > 0xFFFF
    assert int(tax.dense_index(vals).min()) > 0xFFFF  # the real species above u16
    write_kdb(os.path.join(td, "database.kdb"), keys, vals, k=K)
    write_index(os.path.join(td, "database.idx"), NT, np.asarray(offsets, dtype=np.uint64))
    tax.write_taxdb(os.path.join(td, "taxDB"))
    reads = make_demo_reads(genomes, n_reads=400, read_len=150)
    reads += ["ACGT" * 10 + "N" * 5 + "ACGT" * 30, "A" * (K - 1), "N" * 60]
    reads_path = os.path.join(td, "reads.fa")
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return str(td), reads_path


@pytest.fixture(scope="module")
def jax_big(big_tax_db):
    db, _ = big_tax_db
    return {quick: JaxClassifier([db], JaxOptions(print_progress=False, use_native=False, value_pool=False,
                                                  quick=quick, min_hits=2 if quick else 1))
            for quick in (False, True)}


def _feed(reads_path, b=512):
    with open(reads_path, "rb") as f:
        buf = f.read()
    nat = _native_build.native()
    n, offs, _ = nat.parse_unit(buf, False)
    return nat.encode_unit_packed(buf, np.ascontiguousarray(offs), 160, b)


def _both_steps(jc, feed, **cfg_kw):
    """The JAX classify_step and the port's classify_step_core on one span
    feed with the span options and `cfg_kw`."""
    codes, ambig, lengths = feed
    jcfg = dataclasses.replace(jc._cfg, packed_input=True, max_runs=8, **cfg_kw)
    want = classify_step(jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
                         codes, ambig, lengths, jcfg)
    plane = device_db_from_host(
        tuple(np.asarray(x) for x in jc.dbs[0].hash_table), jc.dbs[0].hash_lb, None, jc.k, jc.nt, "cpu"
    ).hash_table
    t = lambda a: T(np.array(a).view(np.int32))
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=jc._cfg.quick,
                     min_hits=jc._cfg.min_hits, packed_input=True, max_runs=8, **cfg_kw)
    got = classify_step_core(
        (plane,), t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1), t(jc._parent),
        int(jc._root_dense), T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths), cfg,
    )
    return got, want


LOCAL = ("packed", "taxa_dense", "ambig", "hll_enc", "hll_dense", "lut")


@pytest.mark.parametrize("cap", [1 << 15, 4], ids=["fits", "overflow"])
@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_local_dict_step_matches_jax(big_tax_db, jax_big, cap, quick):
    _, reads = big_tax_db
    got, want = _both_steps(jax_big[quick], _feed(reads), dense_runs=True, local_dict=True, dict_capacity=cap,
                            outputs=LOCAL)
    assert tuple(got) == LOCAL
    for key in LOCAL:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)
    lut = got["lut"].numpy()
    assert (lut[-1] > cap) == (cap == 4) and lut[-1] > 50
    if cap == 4:  # the dropped ids remap to 0
        assert (lut[:4] < 1 << 30).all() and lut[4] == lut[-1]


@pytest.mark.parametrize("cap", [1 << 15, 4], ids=["fits", "overflow"])
def test_bitmap_dict_step_matches_jax(big_tax_db, jax_big, cap, monkeypatch):
    """The span step with the span dictionary built by the kernels'
    algorithm (span_dict_bitmap: a bit per id, word prefixes, popcount
    ranks; superblocks of 8 words, so the 120k-id space spans 470) equals
    the JAX step: lut, rows and the u16 feed."""
    monkeypatch.setattr(device_step, "span_dict_plain",
                        lambda *a, **k: span_dict_bitmap(*a, **k, super_words=8))
    _, reads = big_tax_db
    got, want = _both_steps(jax_big[False], _feed(reads), dense_runs=True, local_dict=True, dict_capacity=cap,
                            outputs=LOCAL)
    for key in LOCAL:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)


@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_wide_step_matches_jax(big_tax_db, jax_big, quick):
    """The wide rows (run values through the 120k-id taxid table) and the
    u64 hll_pairs feed of ids past u16."""
    _, reads = big_tax_db
    outputs = ("packed", "taxa_dense", "ambig", "hll_pairs")
    got, want = _both_steps(jax_big[quick], _feed(reads), outputs=outputs)
    for key in outputs:
        w = np.asarray(want[key])
        np.testing.assert_array_equal(got[key].numpy().view(w.dtype), w, err_msg=key)
    ids = np.asarray(want["hll_pairs"]) >> np.uint64(32)
    assert (ids[ids != np.uint64(0xFFFFFFFF)] > 0xFFFF).any()


@pytest.mark.parametrize("cap,n_kinds", [(1 << 15, 300), (300, 300), (299, 300), (16, 5000)],
                         ids=["below", "at", "above", "far-above"])
def test_span_dict_plain_edges(cap, n_kinds):
    """n_u below, at and past the capacity, with the ids 0 and T - 1; the
    wrapper takes the plain version on CPU tensors."""
    rng = np.random.default_rng(n_kinds + cap)
    t_ids = 120_000
    kinds = np.unique(np.concatenate([[0, t_ids - 1], rng.choice(np.arange(1, t_ids - 1), n_kinds - 2,
                                                                  replace=False)]))
    assert len(kinds) == n_kinds
    ids = kinds[rng.integers(0, len(kinds), size=(64, 100))].astype(np.int32)
    ids.reshape(-1)[: len(kinds)] = kinds  # every kind occurs
    calls = kinds[rng.integers(0, len(kinds), size=64)].astype(np.int32)
    lut, local, local_call = span_dict(T(ids), T(calls), t_ids, cap)
    assert int(lut[-1]) == len(kinds)
    n = min(cap, len(kinds))
    np.testing.assert_array_equal(lut[:n].numpy(), kinds[:n])
    assert (lut[n:cap].numpy() == 1 << 30).all()
    rank = {int(x): i for i, x in enumerate(kinds)}
    want = np.vectorize(lambda x: rank[x] if rank[x] < cap else 0)(ids)
    np.testing.assert_array_equal(local.numpy(), want)
    np.testing.assert_array_equal(local_call.numpy(), np.vectorize(lambda x: rank[x] if rank[x] < cap else 0)(calls))
    assert span_dict_plain(T(ids), T(calls), t_ids, cap, with_call=False)[2] is None


@pytest.mark.parametrize("t_ids", [120_000, 120_013], ids=["T%32=0", "T%32=13"])
@pytest.mark.parametrize("cap,n_kinds", [(1 << 15, 300), (300, 300), (299, 300), (16, 5000)],
                         ids=["below", "at", "above", "far-above"])
def test_span_dict_bitmap_edges(cap, n_kinds, t_ids):
    """The kernels' algorithm against span_dict_plain and the ranks by hand:
    n_u below, at and past the capacity, with ids 0, 31, 32 (a word's first
    and last bit, the next word) and T - 1, T a multiple of 32 and not, and
    superblocks of 1, 3 and 1024 words."""
    rng = np.random.default_rng(n_kinds + cap + t_ids)
    edge = [0, 31, 32, t_ids - 1]
    kinds = np.unique(np.concatenate([edge, rng.choice(np.arange(33, t_ids - 1), n_kinds - 4, replace=False)]))
    ids = kinds[rng.integers(0, len(kinds), size=(64, 100))].astype(np.int32)
    ids.reshape(-1)[: len(kinds)] = kinds
    calls = kinds[rng.integers(0, len(kinds), size=64)].astype(np.int32)
    want = span_dict_plain(T(ids), T(calls), t_ids, cap)
    for sw in (1, 3, 1024):
        got = span_dict_bitmap(T(ids), T(calls), t_ids, cap, super_words=sw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    rank = {int(x): i for i, x in enumerate(kinds)}
    local = want[1].numpy()
    for x in edge:
        assert (local[ids == x] == (rank[x] if rank[x] < cap else 0)).all()
    assert span_dict_bitmap(T(ids), T(calls), t_ids, cap, with_call=False)[2] is None


@pytest.mark.parametrize("with_call", [True, False])
def test_span_dict_bitmap_outside_range(with_call):
    """Ids outside [0, T) are no entry of the dictionary and remap to 0,
    as the kernels define them; the ids inside keep their ranks."""
    rng = np.random.default_rng(4)
    t_ids, cap = 1000, 64
    ids = rng.integers(0, t_ids, size=(20, 30)).astype(np.int32)
    ids[::3, ::7] = -1
    ids[1::4, 2::5] = t_ids
    ids[2, 3] = np.iinfo(np.int32).min
    calls = rng.integers(0, t_ids, size=20).astype(np.int32)
    calls[::5] = t_ids + 7
    lut, local, local_call = span_dict_bitmap(T(ids), T(calls), t_ids, cap, with_call=with_call)
    x = np.concatenate([ids.reshape(-1), calls])
    kinds = np.unique(x[(x >= 0) & (x < t_ids)])
    assert int(lut[-1]) == len(kinds)
    np.testing.assert_array_equal(lut[: min(cap, len(kinds))].numpy(), kinds[:cap])
    rank = np.full(t_ids, 0, np.int64)
    rank[kinds] = np.where(np.arange(len(kinds)) < cap, np.arange(len(kinds)), 0)
    ok = (ids >= 0) & (ids < t_ids)
    np.testing.assert_array_equal(local.numpy(), np.where(ok, rank[np.clip(ids, 0, t_ids - 1)], 0))
    if with_call:
        ok = (calls >= 0) & (calls < t_ids)
        np.testing.assert_array_equal(local_call.numpy(), np.where(ok, rank[np.clip(calls, 0, t_ids - 1)], 0))
    else:
        assert local_call is None


@pytest.fixture(scope="module")
def loaded(big_tax_db):
    """The port's tables of the fixture database, loaded once (dense ids)."""
    db, _ = big_tax_db
    return Classifier([db], ClassifyOptions(print_progress=False, device="cpu", value_pool=False))


def _run(base, reads, **kw):
    c = Classifier.with_shared_db(base, **kw)
    out, rep = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=out)
    c.write_report(rep)
    return out.getvalue(), rep.getvalue(), c


@pytest.fixture(scope="module")
def python_route(big_tax_db, loaded):
    _, reads = big_tax_db
    return {quick: _run(loaded, reads, use_native=False, quick=quick, min_hits=2 if quick else 1)[:2]
            for quick in (False, True)}


@pytest.mark.parametrize(
    "kw",
    [{}, {"quick": True, "min_hits": 2}, {"dict_capacity": 4}, {"dict_capacity": 4, "quick": True, "min_hits": 2},
     {"device_counters": True}, {"device_counters": True, "dict_capacity": 4},
     {"device_counters": True, "dict_capacity": 4, "quick": True, "min_hits": 2},
     {"device_counters": True, "dict_capacity": 4, "sparse_cap": 4}, {"units": True},
     {"units": True, "dict_capacity": 4}, {"units": True, "device_counters": True}],
    ids=["compact", "quick", "wide", "wide-quick", "counters", "counters-wide", "counters-wide-quick",
         "counters-wide-sparse-overflow", "units", "units-wide", "units-counters"],
)
def test_span_route_matches_python_route(big_tax_db, loaded, python_route, kw, monkeypatch):
    _, reads = big_tax_db
    kw = dict(kw)
    if kw.pop("units", False):
        for name, value in {"WORK_UNIT_SIZE": 3000, "SPAN_READS": 60, "_CHUNK_BYTES": 8192}.items():
            monkeypatch.setattr(pipeline, name, value)
        want = _run(loaded, reads, use_native=False)[:2]
    else:
        want = python_route[kw.get("quick", False)]
    calls = []
    real = Classifier._span_step
    monkeypatch.setattr(Classifier, "_span_step",
                        lambda self, *a, **k: calls.append(k.get("cfg")) or real(self, *a, **k))
    out, rep, c = _run(loaded, reads, **kw)
    assert c.route == "span" and c._cfg_packed.local_dict and c._cfg_packed.dense_runs and c.n_units == 0
    assert c._cfg_packed.dict_capacity == kw.get("dict_capacity", 1 << 15)
    # a 4-id dictionary overflows on the spans that hold more ids: those
    # are run again wide
    wide = [cfg for cfg in calls if cfg is c._cfg_packed_wide]
    assert (len(wide) > 0) == ("dict_capacity" in kw) and len(wide) <= c.n_spans
    if kw.get("device_counters"):
        assert c.dev_counters.lut is not None
        assert c.dev_counters.tracker.overflows == (c.n_spans if "sparse_cap" in kw else 0)
    assert (out, rep) == want


def test_route_and_capacity_checks(big_tax_db, loaded):
    _, reads = big_tax_db
    assert Classifier.with_shared_db(loaded, use_native=False).route == "python"
    with pytest.raises(ValueError, match="dict_capacity"):
        Classifier.with_shared_db(loaded, dict_capacity=0xFFFF)
