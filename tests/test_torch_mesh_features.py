"""The mesh's feature matrix in the port on the CPU (gloo, spawned ranks),
after the JAX package's tests/test_parallel.py::test_mesh_feature_matrix:
UID tables (resident, with device counters and out of core), hierarchical
databases, device counters, a data axis of 3, long reads, quick mode,
--exact and the Python route each write the bytes
of the port's single-device run (kraken output and report, tolerance 0) and
of the reference binaries' goldens where the fixture has one. The JAX
test's (1,4), (2,2), (2,4), (3,2), (2,2), (3,1) meshes become (1,4), (2,2),
(2,2), (3,1), (2,2), (3,1): each rank is a process."""

import io
import os

import pytest
import torch

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.parallel.mesh import run_mesh

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


def _single(dbs, reads, uid=False, **kw):
    c = Classifier(dbs, ClassifyOptions(device="cpu", print_progress=False, **kw), uid_database=uid)
    out, rep = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=out)
    c.write_report(rep)
    return out.getvalue(), rep.getvalue()


@pytest.mark.parametrize(
    "mode,n_data,n_db",
    [
        ("uid", 1, 4),
        ("hier", 2, 2),
        ("device_counters", 2, 2),
        ("nonpow2", 3, 1),
        ("long_reads", 2, 2),
        ("quick", 3, 1),
        ("exact", 1, 2),
        ("python_route", 2, 2),
        ("uid_device_counters", 2, 2),
        ("uid_out_of_core", 1, 2),
    ],
)
def test_mesh_feature_matrix(mode, n_data, n_db, tmp_path):
    reads, dbs, kw, uid, golden = READS, [DATA], {}, False, None
    if mode.startswith("uid"):
        uid, golden = True, "kraken_uid.out"
        if mode == "uid_device_counters":
            kw = {"device_counters": True}
        elif mode == "uid_out_of_core":  # raw chunk tables in groups of the 2 db ranks
            kw = {"preload_size": 20_000}
    elif mode == "hier":
        dbs, golden = [os.path.join(DATA, "db_bact"), os.path.join(DATA, "db_viral")], "kraken_hier.out"
    elif mode == "device_counters":
        kw, golden = {"device_counters": True}, "kraken.out"
    elif mode == "quick":
        kw, golden = {"quick": True, "min_hits": 2}, "kraken_quick.out"
    elif mode == "long_reads":
        # one read past max_read_len: its chunk takes the Python route and
        # its long-read steps run on every rank
        with open(READS) as f:
            src = f.read().splitlines()
        seqs = [line for line in src if not line.startswith(">")]
        lr = tmp_path / "long.fa"
        lr.write_text(f">long1\n{''.join(seqs)[:3000]}\n" + "\n".join(src[:12]) + "\n")
        reads, kw = str(lr), {"max_read_len": 1024}
    elif mode == "exact":
        kw = {"exact": True}
    elif mode == "python_route":
        kw, golden = {"use_native": False}, "kraken.out"
    else:
        golden = "kraken.out"
    out0, rep0 = _single(dbs, reads, uid, **kw)
    got = run_mesh(dbs, ClassifyOptions(device="cpu", print_progress=False, mesh_data=n_data, mesh_db=n_db, **kw),
                   [reads], uid_database=uid, timeout=MESH_TIMEOUT)
    assert got["kraken"] == out0
    assert got["report"] == rep0
    if golden:
        with open(os.path.join(DATA, golden)) as f:
            assert got["kraken"] == f.read()
