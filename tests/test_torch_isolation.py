"""The port stands alone: krakenuniq_tpu_torch and chip_smoke.py import
neither jax nor anything of krakenuniq_tpu, importing them builds nothing,
the port's native module is its own (never krakenuniq_tpu's kuniq_native
library), and a CUDA run without a card raises instead of falling back to
the CPU."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import krakenuniq_tpu_torch
from krakenuniq_tpu_torch import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "krakenuniq_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "krakenuniq_tpu")


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(krakenuniq_tpu_torch.__path__, "krakenuniq_tpu_torch.")
    )


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel builds, scratch data
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "krakenuniq_tpu_torch.classify.pipeline" in mods
    assert "krakenuniq_tpu_torch.classify.device_counters" in mods
    assert "krakenuniq_tpu_torch.tools.probe_gather" in mods
    assert "krakenuniq_tpu_torch.parallel.partition" in mods
    assert "krakenuniq_tpu_torch.parallel.mesh" in mods
    assert "krakenuniq_tpu_torch.parallel.multihost" in mods
    assert "krakenuniq_tpu_torch.db.chunked" in mods
    for m in ("build.db_build", "build.download", "build.uid_build", "cli.tools", "cli.build_main",
              "cli.download_main", "report.accuracy", "report.postprocess", "report.extract_reads",
              "report.grade", "formats.seqmap", "utils.simulate"):
        assert f"krakenuniq_tpu_torch.{m}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'krakenuniq_tpu' or m.startswith('krakenuniq_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the card-less behaviour")
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions

    data = os.path.join(ROOT, "tests", "golden", "data")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Classifier([data], ClassifyOptions(print_progress=False, device="cuda"))


@pytest.mark.parametrize("entry", ["build_main", "simulate_and_grade"])
def test_build_and_accuracy_default_to_the_card(entry, tmp_path):
    """The build's step 6b and the accuracy loop classify on the card unless
    asked for the CPU: with no card, their defaults raise as the
    Classifier's do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the card-less behaviour")
    data = os.path.join(ROOT, "tests", "golden", "data")
    if entry == "build_main":
        from krakenuniq_tpu_torch.cli.build_main import main

        db = tmp_path / "DB"
        (db / "library").mkdir(parents=True)
        shutil.copy(os.path.join(data, "library.fna"), db / "library")
        shutil.copy(os.path.join(data, "seqid2taxid.map"), db / "library" / "library.map")
        shutil.copytree(os.path.join(data, "taxonomy"), db / "taxonomy")
        argv = ["--db", str(db), "--kmer-len", "21", "--minimizer-len", "7"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        # the failed step 6b leaves no report header behind (F9): a rerun on
        # the CPU runs it
        assert (db / "database.kdb").exists() and not (db / "database.report.tsv").exists()
        assert main(argv + ["--device", "cpu"]) == 0
        assert (db / "database.kraken.tsv").read_text().count("\n") == 5
    else:
        from krakenuniq_tpu_torch.report.accuracy import simulate_and_grade

        with pytest.raises(RuntimeError, match="no CUDA device"):
            simulate_and_grade(data, str(tmp_path), library_fastas=[os.path.join(data, "library.fna")],
                               n_reads=10)


def test_mesh_ranks_default_to_the_card(tmp_path):
    """spawn_mesh, run_mesh and the CLI's --mesh put their ranks on the card
    unless asked for the CPU: with no card they raise before any rank
    starts, as the Classifier does; a Classifier with mesh options outside
    a torch.distributed world of that size raises too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the card-less behaviour")
    from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
    from krakenuniq_tpu_torch.cli.main import main
    from krakenuniq_tpu_torch.parallel.mesh import classify_rank, run_mesh, spawn_mesh

    data = os.path.join(ROOT, "tests", "golden", "data")
    reads = os.path.join(data, "reads.fa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_mesh(classify_rank, 1, 2, args=([data], ClassifyOptions(mesh_db=2), [reads]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mesh([data], ClassifyOptions(print_progress=False, mesh_data=2), [reads])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--db", data, "--mesh", "1x2", "--output", str(tmp_path / "k.out"), reads])
    assert not (tmp_path / "k.out").exists()
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        Classifier([data], ClassifyOptions(print_progress=False, device="cpu", mesh_data=1, mesh_db=2))


def test_nccl_on_the_cpu_raises():
    """Asking for NCCL where it cannot run raises; nothing falls back to
    gloo."""
    from krakenuniq_tpu_torch.parallel.mesh import choose_backend, classify_rank, spawn_mesh
    from krakenuniq_tpu_torch.parallel.multihost import initialize

    assert choose_backend(2, "cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        choose_backend(2, "cpu", "nccl")
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        spawn_mesh(classify_rank, 1, 2, "cpu", backend="nccl")
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        initialize("tcp://127.0.0.1:1", num_processes=2, process_id=0, platform="cpu", backend="nccl")


def test_a_failing_rank_fails_the_mesh(tmp_path):
    """Every rank raising (no database there) fails spawn_mesh; the error is
    never caught into a result."""
    from krakenuniq_tpu_torch.classify import ClassifyOptions
    from krakenuniq_tpu_torch.parallel.mesh import run_mesh

    reads = os.path.join(ROOT, "tests", "golden", "data", "reads.fa")
    with pytest.raises(Exception, match="taxDB"):
        run_mesh([str(tmp_path)], ClassifyOptions(print_progress=False, device="cpu", mesh_db=2), [reads],
                 timeout=120)


def test_kernel_wrappers_refuse_cpu_launch():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _kernels.check_cuda("scores", tins=x, touts=x)
    with pytest.raises(ValueError, match="several devices"):
        _kernels.check_cuda("scores", tins=x, touts=x.to("meta"))
    assert set(_kernels.LAUNCHES) == {
        "scores", "kmer_front", "chd_probe", "taxon_counts", "hll_regmax", "row_gather",
        "pack_runs", "sparse_stats", "span_dict", "sparse_keys", "chd_probe_acc",
        "fused_probe", "kmer_bins", "bsearch_lookup", "bsearch_words", "rows_probe", "rows_probe_acc",
    }
    # one library per source; sparse_keys is an entry of sparse_stats'
    # library, chd_probe_acc, fused_probe, rows_probe and rows_probe_acc of
    # chd_probe's, kmer_bins (both feeds) of kmer_front's, bsearch_words of
    # bsearch_lookup's
    assert sorted(f[:-3] for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith(".cu")) == sorted(
        _kernels.SIGNATURES)
    assert set(_kernels.LAUNCHES) == {*_kernels.SIGNATURES, "sparse_keys", "chd_probe_acc", "fused_probe",
                                      "kmer_bins", "bsearch_words", "rows_probe", "rows_probe_acc"}
    assert _kernels.ENTRIES["chd_probe_acc"][0] == _kernels.ENTRIES["fused_probe"][0] == "chd_probe"
    assert _kernels.ENTRIES["rows_probe"][0] == _kernels.ENTRIES["rows_probe_acc"][0] == "chd_probe"
    assert _kernels.ENTRIES["kmer_bins"][0] == _kernels.ENTRIES["kmer_bins_packed"][0] == "kmer_front"
    assert _kernels.ENTRIES["bsearch_words"][0] == "bsearch_lookup"


def test_kernel_digest_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and the csrc/ headers it includes:
    an edit to kmer_window.cuh renames the libraries of kmer_front.cu,
    chd_probe.cu and bsearch_lookup.cu (so no stale build is reused) and no
    other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(PKG, "csrc"), csrc)
    monkeypatch.setattr(_kernels, "CSRC", str(csrc))
    before = {n: _kernels._lib_path(n) for n in _kernels.SIGNATURES}
    with open(csrc / "kmer_window.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = {n: _kernels._lib_path(n) for n in _kernels.SIGNATURES}
    assert {n for n in before if before[n] != after[n]} == {"kmer_front", "chd_probe", "bsearch_lookup"}


def test_native_loader_is_the_ports_own():
    """Importing every port module starts no compiler; the span route's
    loader then builds (or reuses) kuniq_native_torch under the port's
    _build/ and never maps the JAX package's kuniq_native library."""
    mods = _port_modules()
    code = (
        "import subprocess, sys\n"
        "sys.modules['jax'] = None\n"
        "calls = []\n"
        "real_run, real_popen = subprocess.run, subprocess.Popen\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real_run(*a, **k)\n"
        "subprocess.Popen = lambda *a, **k: calls.append(a) or real_popen(*a, **k)\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from krakenuniq_tpu_torch import _native_build\n"
        "assert not calls and _native_build._module is None, calls\n"
        "mod = _native_build.native()\n"
        "assert mod.__name__ == 'kuniq_native_torch', mod\n"
        "assert mod.__file__.startswith(_native_build.BUILD_DIR), mod.__file__\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'krakenuniq_tpu/kuniq_native' not in maps\n"
        "assert 'kuniq_native_torch' in maps\n"
        "bad = [m for m in sys.modules if m == 'krakenuniq_tpu' or m.startswith('krakenuniq_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
