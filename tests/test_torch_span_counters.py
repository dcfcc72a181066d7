"""--device-counters on the port's span route (krakenuniq_tpu_torch.classify)
on the CPU: `classify_and_count_core` against the JAX package's
`_classify_and_count_core` on the same packed span (registers, both
counters and the sparse-stats buffer, in the value-pool and lut register
layouts, and counts only); the span route with device counters against the
goldens, the span route's host fold and the Python route with device
counters, across work units and spans; the sparse buffer's overflow
redispatch; the host-stats form; and `DeviceCounters(counts_only=True)`
against the JAX class."""

import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify import device_counters as JD
from krakenuniq_tpu.classify.device_step import _classify_and_count_core
from krakenuniq_tpu_torch import _native_build
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions, pipeline
from krakenuniq_tpu_torch.classify import device_counters as TD
from krakenuniq_tpu_torch.classify import sparse_exact as TS
from krakenuniq_tpu_torch.classify.device_step import StepConfig, classify_and_count_core
from krakenuniq_tpu_torch.db.device_db import device_db_from_host
from krakenuniq_tpu_torch.hll import ExactCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
T = torch.from_numpy
SPAN_OUTPUTS = ("packed", "taxa_dense", "ambig")


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


def _span_feed():
    """The golden reads plus an all-N read and an N-riddled one, parsed and
    bit-packed by the port's native module into 192 rows; three work units."""
    with open(os.path.join(DATA, "reads.fa"), "rb") as f:
        buf = f.read() + b">n\n" + b"N" * 40 + b"\n>m\n" + b"ACGTN" * 20 + b"\n"
    nat = _native_build.native()
    n, offs, _ = nat.parse_unit(buf, False)
    codes, ambig, lengths = nat.encode_unit_packed(buf, np.ascontiguousarray(offs), 160, 192)
    return codes, ambig, lengths, n, [0, 50, 101, n]


# name: (value_pool, counts_only, quick)
LAYOUTS = {"pool": (True, False, False), "lut": (False, False, False), "lut-quick": (False, False, True),
           "counts-only": (True, True, False)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_classify_and_count_matches_jax(layout):
    value_pool, counts_only, quick = LAYOUTS[layout]
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, use_native=False, value_pool=value_pool,
                                          quick=quick, min_hits=2 if quick else 1))
    codes, ambig, lengths, n, bounds = _span_feed()
    unit_id = pipeline.Classifier._unit_id_rows(bounds, codes.shape[0])
    assert unit_id.tolist()[-1] == 2 and len(unit_id) == codes.shape[0]
    p, cap = 12, 1 << 14
    if value_pool:
        n_ids, pool_dense = jc._pool.size, None
    else:
        n_ids, pool_dense = jc.taxonomy.size, np.unique(jc.dbs[0].vals_dense)
    jdc = JD.DeviceCounters(n_ids, p, pool_dense=pool_dense, sparse_cap=cap, counts_only=counts_only)
    tdc = TD.DeviceCounters(n_ids, p, pool_dense=pool_dense, sparse_cap=cap, counts_only=counts_only,
                            device="cpu")
    assert (tdc.lut is None) == jdc.identity_pool or counts_only
    jcfg = dataclasses.replace(jc._cfg, packed_input=True, max_runs=8, dense_runs=True, outputs=SPAN_OUTPUTS)
    want_out, want_state, want_sp = _classify_and_count_core(
        *jdc.state(), jdc.pool_maps, jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent,
        jc._root_dense, codes, ambig, lengths, np.int32(n), jnp.asarray(unit_id), jcfg, p, jdc.sparse_cap,
        counts_only, jdc.identity_pool,
    )
    plane = device_db_from_host(
        tuple(np.asarray(x) for x in jc.dbs[0].hash_table), jc.dbs[0].hash_lb, jc._pool, jc.k, jc.nt, "cpu"
    ).hash_table
    t = lambda a: T(np.array(a).view(np.int32))
    cfg = StepConfig(k=jc.k, max_depth=jc._cfg.max_depth, hll_p=jc._cfg.hll_p, quick=quick,
                     min_hits=jc._cfg.min_hits, packed_input=True, max_runs=8, dense_runs=True,
                     outputs=SPAN_OUTPUTS)
    got_out, got_sp = classify_and_count_core(
        *tdc.state(), tdc.lut, (plane,), t(jc._taxid_table), torch.stack([t(jc._tin), t(jc._tout)], dim=1),
        t(jc._parent), int(jc._root_dense), T(codes.view(np.int32)), T(ambig.view(np.int32)), T(lengths),
        n, T(unit_id), cfg, p, tdc.sparse_cap, counts_only,
    )
    assert tuple(got_out) == SPAN_OUTPUTS
    for key in SPAN_OUTPUTS:
        w = np.asarray(want_out[key])
        np.testing.assert_array_equal(got_out[key].numpy().view(w.dtype), w, err_msg=key)
    for name, g, w in zip(("registers", "kmer_counts", "read_counts"), tdc.state(), want_state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{layout}: {name}")
    assert len(got_sp) == len(want_sp) == (0 if counts_only else 3)
    if not counts_only:
        np.testing.assert_array_equal(got_sp[0].numpy().view(np.uint64), np.asarray(want_sp[0]))
        assert (int(got_sp[1]), int(got_sp[2])) == (int(want_sp[1]), int(want_sp[2]))
        assert int(got_sp[1]) > 0 and int(got_sp[2]) > 0, "the span should hold pairs and events"
        assert (tdc.reg.numpy() > 0).any()
    assert int(tdc.read_counts.sum()) == n  # one call counted per read, none for the padded rows


def _run(reads, dbs=(".",), **opts):
    c = Classifier([os.path.join(DATA, d) for d in dbs],
                   ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([os.path.join(DATA, reads)], kraken_fh=kraken)
    c.write_report(report)
    return c, kraken.getvalue(), report.getvalue()


# (reads, databases, options, kraken golden, report golden)
CASES = {
    "fasta": ("reads.fa", (".",), {}, "kraken.out", "report.tsv"),
    "fastq": ("reads.fq", (".",), {}, "kraken_fq.out", "report_fq.tsv"),
    "quick": ("reads.fa", (".",), {"quick": True, "min_hits": 2}, "kraken_quick.out", None),
    "hierarchical": ("reads.fa", ("db_bact", "db_viral"), {}, "kraken_hier.out", "report_hier.tsv"),
    "dense-ids": ("reads.fa", (".",), {"value_pool": False}, "kraken.out", "report.tsv"),
}
# many work units and spans: each span's counters cover several units
SMALL = {"WORK_UNIT_SIZE": 1500, "SPAN_READS": 40, "_CHUNK_BYTES": 4096}


@pytest.mark.parametrize("knobs", ["default", "units"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counters_match_golden_and_python_route(case, knobs, monkeypatch):
    reads, dbs, opts, kraken_golden, report_golden = CASES[case]
    if knobs == "units":
        for name, value in SMALL.items():
            monkeypatch.setattr(pipeline, name, value)
    c, kraken, report = _run(reads, dbs, device_counters=True, **opts)
    assert c.route == "span" and c.n_units == 0 and c.n_spans >= (4 if knobs == "units" else 1)
    assert c.dev_counters.tracker.overflows == 0
    assert c.span_host_seconds["fold"] == 0.0
    c_py, kraken_py, report_py = _run(reads, dbs, device_counters=True, use_native=False, **opts)
    assert c_py.route == "python" and c_py.n_units > 0
    assert (kraken, report) == (kraken_py, report_py)
    assert kraken == _golden(kraken_golden)
    if knobs == "default":
        assert (kraken, report) == _run(reads, dbs, **opts)[1:]  # the span route's host fold
        if report_golden:
            assert report == _golden(report_golden)


@pytest.mark.parametrize("knobs", ["default", "units"])
def test_span_sparse_overflow_redispatches(knobs, monkeypatch):
    """A 4-slot sparse buffer overflows on every span: the span is run
    again for its planes and its stats are made on the host."""
    if knobs == "units":
        for name, value in SMALL.items():
            monkeypatch.setattr(pipeline, name, value)
    c, kraken, report = _run("reads.fa", device_counters=True, sparse_cap=4)
    assert c.dev_counters.tracker.overflows == c.n_spans > (3 if knobs == "units" else 0)
    assert (kraken, report) == _run("reads.fa", device_counters=True, use_native=False)[1:]
    assert kraken == _golden("kraken.out")


def test_span_host_stats(monkeypatch):
    """Ids past the device packing (a monkeypatched TAXON_BITS): the span
    returns enc and hll_lanes and the host makes the stats, bit-exact."""
    monkeypatch.setattr(TS, "TAXON_BITS", 2)
    for name, value in SMALL.items():
        monkeypatch.setattr(pipeline, name, value)
    c, kraken, report = _run("reads.fa", device_counters=True, value_pool=False)
    assert c.route == "span" and c.dev_counters.host_stats and c.dev_counters.sparse_cap == 0
    assert {"enc", "hll_lanes"} <= set(c._cfg_packed.outputs)
    assert (kraken, report) == _run("reads.fa", value_pool=False)[1:]
    assert kraken == _golden("kraken.out")


def test_counts_only_matches_jax():
    """DeviceCounters(counts_only=True): a one-row register pool, no
    tracker, the JAX class's counters after the same updates, and
    ExactCounter k-mer sets at finalize."""
    rng = np.random.default_rng(5)
    t, b, w, p = 40, 24, 30, 12
    jdc = JD.DeviceCounters(t, p, counts_only=True)
    tdc = TD.DeviceCounters(t, p, counts_only=True, device="cpu")
    assert tdc.reg.shape == (1, 1 << p) == jdc.reg.shape
    assert tdc.tracker is None and jdc.tracker is None and tdc.sparse_cap == jdc.sparse_cap == 0
    for _ in range(2):
        taxa = rng.integers(0, t, size=(b, w)).astype(np.int32)
        enc = rng.integers(0, 1 << 32, size=(b, w), dtype=np.uint64).astype(np.uint32)
        lanes = rng.random((b, w)) < 0.8
        call = rng.integers(0, t, size=b).astype(np.int32)
        valid = rng.random(b) < 0.9
        jdc.update(jnp.asarray(taxa), jnp.asarray(enc), jnp.asarray(lanes), jnp.asarray(call), jnp.asarray(valid))
        tdc.update(T(taxa), T(enc.view(np.int32)), T(lanes), T(call), T(valid))
    for g, w_ in zip(tdc.state(), jdc.state()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    taxids = np.arange(t, dtype=np.uint32) * 10
    got, want = tdc.finalize(taxids), jdc.finalize(taxids)
    assert set(got) == set(want) and got
    for tid, rc in got.items():
        assert (rc.n_reads, rc.n_kmers) == (want[tid].n_reads, want[tid].n_kmers)
        assert isinstance(rc.kmers, ExactCounter) and rc.kmers.cardinality() == want[tid].kmers.cardinality() == 0
