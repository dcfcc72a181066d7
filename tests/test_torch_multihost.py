"""Multi-host classification in the port on the CPU, after the JAX
package's tests/test_multihost.py: span-interleaved input sharding, the
counter-state fold, the manifest-ordered output merge and the
torch.distributed bring-up. Every merged run is byte-equal to the port's
single-host run at the same span geometry (tolerance 0) and to the
reference binaries' golden kraken output. The JAX package is imported only
inside the tests that compare with it, so that a spawned worker of this
module imports the port alone."""

import io
import multiprocessing as mp
import os
import socket
import sys

import numpy as np
import pytest
import torch

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.parallel.multihost import (
    load_counter_state,
    merge_counts,
    merge_kraken_outputs,
    owns_span,
    save_counter_state,
)
from krakenuniq_tpu_torch.report import DEFAULT_COLS, TaxReport

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


def _opts(**kw):
    return ClassifyOptions(device="cpu", print_progress=False, **kw)


def _single_host(uid=False, **kw):
    c = Classifier([DATA], _opts(**kw), uid_database=uid)
    out, rep = io.StringIO(), io.StringIO()
    c.run([READS], kraken_fh=out)
    c.write_report(rep)
    return out.getvalue(), rep.getvalue()


def _tiny_budget():
    from krakenuniq_tpu_torch.db.chunked import table_bytes
    from krakenuniq_tpu_torch.formats.kdb import read_header
    from krakenuniq_tpu_torch.taxonomy import Taxonomy

    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    hdr = read_header(os.path.join(DATA, "database.kdb"))
    return max(1024, table_bytes(hdr.key_ct, tax.size - 1, False) // 4)


def _merged_report(taxonomy_classifier, counts):
    taxonomy_classifier.ensure_counts_files()
    rep = TaxReport(taxonomy_classifier.taxonomy, counts)
    rep.set_cols(DEFAULT_COLS)
    buf = io.StringIO()
    rep.write(buf)
    return buf.getvalue()


def _run_hosts(tmp_path, n_hosts, uid=False, **kw):
    """Every host's run in this process: the merged kraken output, the
    folded counts, the first host's Classifier, the manifests."""
    parts, merged_counts, hosts = [], {}, []
    for hid in range(n_hosts):
        c = Classifier([DATA], _opts(host_id=hid, n_hosts=n_hosts, **kw), uid_database=uid)
        kp = tmp_path / f"k{hid}.out"
        with open(kp, "w") as fh:
            c.run([READS], kraken_fh=fh)
        parts.append((str(kp), c.span_manifest))
        merge_counts(merged_counts, c.finalized_counts())
        hosts.append(c)
    span_ids = sorted(i for _p, m in parts for i, _a, _b in m)
    assert span_ids == list(range(len(span_ids)))
    assert all(owns_span(i, h, n_hosts) for h, (_p, m) in enumerate(parts) for i, _a, _b in m)
    merged = tmp_path / "merged.out"
    merge_kraken_outputs(str(merged), parts)
    return merged.read_text(), merged_counts, hosts[0], parts


@pytest.mark.parametrize("kw", [{}, {"device_counters": True}, {"exact": True}, {"preload_size": "tiny"}],
                         ids=["hll", "device_counters", "exact", "out_of_core"])
def test_multihost_merge_equals_single(tmp_path, kw):
    """2-way span sharding: the merged kraken output and the folded report
    equal the single-host run, in every accumulation mode and out of core."""
    if kw.get("preload_size") == "tiny":
        kw = {**kw, "preload_size": _tiny_budget()}
    geo = {"work_unit_size": 2000, "device_batch_reads": 64}
    merged, counts, first, parts = _run_hosts(tmp_path, 2, **geo, **kw)
    assert all(m for _p, m in parts), "both hosts own spans"
    out0, rep0 = _single_host(**geo, **kw)
    assert merged == out0
    with open(os.path.join(DATA, "kraken.out")) as f:
        assert merged == f.read()
    assert _merged_report(first, counts) == rep0


@pytest.mark.parametrize(
    "kw,uid",
    [({}, False), ({"preload_size": "tiny"}, False), ({}, True), ({"device_counters": True}, True)],
    ids=["hll", "out_of_core", "uid", "uid_device_counters"],
)
def test_multihost_4way_matrix(tmp_path, kw, uid):
    if kw.get("preload_size") == "tiny":
        kw = {**kw, "preload_size": _tiny_budget()}
    geo = {"work_unit_size": 1000, "device_batch_reads": 32}
    merged, counts, first, parts = _run_hosts(tmp_path, 4, uid=uid, **geo, **kw)
    assert len({i for _p, m in parts if m for i, _a, _b in m}) >= 4
    out0, rep0 = _single_host(uid=uid, **geo, **kw)
    assert merged == out0
    assert _merged_report(first, counts) == rep0


def test_multihost_composes_with_mesh(tmp_path):
    """Two hosts, each a 1x2 mesh of spawned ranks (hosts x cards): merged,
    byte-equal to the single-host single-device run at the same geometry."""
    from krakenuniq_tpu_torch.parallel.mesh import run_mesh

    geo = {"work_unit_size": 2000, "device_batch_reads": 64}
    parts, counts, first = [], {}, None
    for hid in range(2):
        got = run_mesh([DATA], _opts(host_id=hid, n_hosts=2, mesh_data=1, mesh_db=2, **geo), [READS],
                       timeout=MESH_TIMEOUT)
        kp = tmp_path / f"k{hid}.out"
        kp.write_text(got["kraken"])
        assert got["span_manifest"] and got["merge_calls"] > 0
        parts.append((str(kp), got["span_manifest"]))
        merge_counts(counts, got["counts"])
    merged = tmp_path / "merged.out"
    merge_kraken_outputs(str(merged), parts)
    out0, rep0 = _single_host(**geo)
    assert merged.read_text() == out0
    first = Classifier([DATA], _opts(**geo))
    assert _merged_report(first, counts) == rep0


def _assert_counts_equal(a, b):
    assert set(a) == set(b)
    for t in a:
        assert (a[t].n_reads, a[t].n_kmers) == (b[t].n_reads, b[t].n_kmers)
        x, y = a[t].kmers, b[t].kmers
        assert (x is None) == (y is None)
        if x is None:
            continue
        if hasattr(x, "sparse"):
            assert (x.p, x.sparse, x.n_observed) == (y.p, y.sparse, y.n_observed)
            np.testing.assert_array_equal(x.sparse_set, y.sparse_set)
            assert (x.M is None) == (y.M is None)
            if x.M is not None:
                np.testing.assert_array_equal(x.M, y.M)
        else:
            np.testing.assert_array_equal(x.kmers, y.kmers)


@pytest.mark.parametrize("exact", [False, True], ids=["hll", "exact"])
def test_multihost_state_roundtrip(tmp_path, exact):
    """Counter-state files reload to equal counts (HLL sparse and dense,
    exact sets, plain counters), and a state written by one package loads
    in the other to the same counts."""
    from krakenuniq_tpu.parallel import multihost as jax_multihost

    c = Classifier([DATA], _opts(exact=exact))
    c.run([READS])
    counts = c.finalized_counts()
    p = str(tmp_path / "state.bin")
    save_counter_state(p, counts)
    _assert_counts_equal(load_counter_state(p), counts)
    _assert_counts_equal(jax_multihost.load_counter_state(p), counts)
    q = str(tmp_path / "state_jax.bin")
    jax_multihost.save_counter_state(q, jax_multihost.load_counter_state(p))
    _assert_counts_equal(load_counter_state(q), counts)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def test_finalized_counts_do_not_alias_live_state():
    """finalized_counts() returns fresh objects: folding another host's
    state into it twice leaves the classifier's own report as it was."""
    for kw in ({}, {"device_counters": True}):
        c = Classifier([DATA], _opts(**kw))
        c.run([READS])
        before = io.StringIO()
        c.write_report(before)
        merged, other = c.finalized_counts(), c.finalized_counts()
        merge_counts(merged, other)
        merge_counts(merged, other)
        after = io.StringIO()
        c.write_report(after)
        assert after.getvalue() == before.getvalue()
        # extra_counts folds into a copy as well
        twice = io.StringIO()
        c.write_report(twice, extra_counts=[other])
        assert twice.getvalue() != before.getvalue()
        again = io.StringIO()
        c.write_report(again)
        assert again.getvalue() == before.getvalue()


def test_merge_counts_does_not_mutate_other():
    from krakenuniq_tpu_torch.hll import HLL, ReadCounts

    def one():
        k = HLL(12)
        k.insert_items(np.asarray([7, 9], np.uint64))
        rc = ReadCounts(k)
        rc.n_reads, rc.n_kmers = 3, 5
        return {42: rc}

    src = one()
    into = merge_counts({}, src)
    assert src[42].n_reads == 3
    merge_counts(into, src)
    assert into[42].n_reads == 6 and src[42].n_reads == 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_worker(pid, port, tmpdir):
    import traceback

    log = open(os.path.join(tmpdir, f"w{pid}.log"), "w")
    sys.stdout = sys.stderr = log
    try:
        import torch
        import torch.distributed as dist

        from krakenuniq_tpu_torch.parallel.multihost import initialize

        assert initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, platform="cpu") == (pid, 2)
        assert dist.get_backend() == "gloo"
        x = torch.tensor([pid + 1], dtype=torch.int64)
        dist.all_reduce(x)
        y = torch.tensor([pid + 1], dtype=torch.int32)
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        assert int(x) == 3 and int(y) == 2, (x, y)
        dist.destroy_process_group()
        print("DIST_OK", pid, flush=True)
    except Exception:
        traceback.print_exc()
    finally:
        log.flush()


def test_distributed_initialize_all_reduce(tmp_path):
    """torch.distributed brought up by `initialize` over 2 CPU processes
    (gloo, a tcp:// rendezvous): an all_reduce (SUM, int64) and an
    all_reduce (MAX, int32) across them. A hung worker fails the test."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    ps = [ctx.Process(target=_dist_worker, args=(i, port, str(tmp_path))) for i in range(2)]
    [p.start() for p in ps]
    [p.join(timeout=120) for p in ps]
    for p in ps:
        if p.is_alive():
            p.terminate()
            pytest.fail("distributed worker hung")
    for i in range(2):
        log = open(tmp_path / f"w{i}.log").read()
        assert f"DIST_OK {i}" in log, log[-1500:]


def test_initialize_without_address_starts_nothing(monkeypatch):
    from krakenuniq_tpu_torch.parallel.multihost import initialize

    for var in ("KUNIQ_COORDINATOR", "KUNIQ_NUM_PROCS", "KUNIQ_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() == (0, 1)
    with pytest.raises(ValueError, match="process count"):
        initialize("tcp://127.0.0.1:1")
