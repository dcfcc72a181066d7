"""The port's CLI across hosts and on a mesh, on the CPU, after the JAX
package's tests/test_multihost.py CLI cases: --multihost with the auto
collect (host 0 merges every host's segment and counter state), with the
manual collect (--multihost-collect off, --multihost-merge), with a host
killed mid-run (--multihost-recover off fails with 75 and names it; auto
re-runs its share), and --mesh (spawned ranks, rank 0 writes), each
byte-equal to the single-host CLI run: the kraken output and the report's
body (its '#' header names the command line)."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from krakenuniq_tpu_torch.parallel.multihost import merge_kraken_outputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")
CLI = [sys.executable, "-m", "krakenuniq_tpu_torch.cli.main", "--device", "cpu", "--db", DATA, READS]

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "kraken.out")), reason="golden fixture missing"
)


def _env():
    # one torch thread a process: the suite runs in several pytest-xdist
    # workers on one host
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _run_cli(extra, out, rep):
    r = subprocess.run(CLI + ["--output", out, "--report-file", rep] + extra, capture_output=True, text=True,
                       env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def _body(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("single_cli")
    out, rep = str(d / "s.out"), str(d / "s.tsv")
    _run_cli([], out, rep)
    with open(out, "rb") as f:
        kraken = f.read()
    with open(os.path.join(DATA, "kraken.out"), "rb") as f:
        assert kraken == f.read()
    return kraken, _body(rep)


def test_multihost_cli_auto_collect(tmp_path, single):
    out, rep = str(tmp_path / "m.out"), str(tmp_path / "m.tsv")
    # the same command on every host; host 1 first, so that host 0's
    # rendezvous finds its marker down
    _run_cli(["--multihost", "1/2"], out, rep)
    _run_cli(["--multihost", "0/2"], out, rep)
    with open(out, "rb") as f:
        assert f.read() == single[0]
    assert _body(rep) == single[1]
    assert not os.path.exists(out + ".done0") and not os.path.exists(out + ".done1")
    assert os.path.exists(out + ".part0.manifest") and os.path.exists(rep + ".state.1")


def test_multihost_cli_manual_collect(tmp_path, single):
    o1, r1 = str(tmp_path / "h1.out"), str(tmp_path / "h1.tsv")
    _run_cli(["--multihost", "1/2", "--multihost-collect", "off"], o1, r1)
    o0, r0 = str(tmp_path / "h0.out"), str(tmp_path / "h0.tsv")
    _run_cli(["--multihost", "0/2", "--multihost-collect", "off", "--multihost-merge", f"{r1}.state.1"], o0, r0)
    parts = []
    for p in (o0, o1):
        with open(p + ".manifest") as mf:
            parts.append((p, json.load(mf)))
    merged = tmp_path / "merged.out"
    merge_kraken_outputs(str(merged), parts)
    assert merged.read_bytes() == single[0]
    assert _body(r0) == single[1]


def test_multihost_host_loss_recovery(tmp_path, single):
    """Host 1 killed before it finishes: host 0's rendezvous times out
    naming it; with --multihost-recover off it exits 75 with the recovery
    command, with auto it re-runs host 1's spans itself."""
    out, rep = str(tmp_path / "m.out"), str(tmp_path / "m.tsv")
    p1 = subprocess.Popen(CLI + ["--output", out, "--report-file", rep, "--multihost", "1/2"], env=_env(),
                          cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    time.sleep(1.0)
    p1.send_signal(signal.SIGKILL)
    p1.wait()
    assert not os.path.exists(out + ".done1")
    base = CLI + ["--output", out, "--report-file", rep, "--multihost", "0/2", "--multihost-wait", "2"]
    r = subprocess.run(base + ["--multihost-recover", "off"], capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=300)
    assert r.returncode == 75
    assert "lost host 1" in r.stderr and "s % 2 == 1" in r.stderr and "--multihost" in r.stderr
    r = subprocess.run(base, capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Recovering lost host 1" in r.stderr
    with open(out, "rb") as f:
        assert f.read() == single[0]
    assert _body(rep) == single[1]


@pytest.mark.parametrize("extra", [["--mesh", "2x2"], ["--mesh", "1x2", "--device-counters"]],
                         ids=["2x2", "1x2_device_counters"])
def test_mesh_cli(tmp_path, single, extra):
    out, rep = str(tmp_path / "m.out"), str(tmp_path / "m.tsv")
    r = _run_cli(extra, out, rep)
    assert "backend gloo" in r.stderr
    with open(out, "rb") as f:
        assert f.read() == single[0]
    assert _body(rep) == single[1]


def test_mesh_cli_bad_shape(tmp_path):
    r = subprocess.run(CLI + ["--mesh", "2by2"], capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 1 and "--mesh expects DATAxDB" in r.stderr
