"""run.py fails without a card, and without the program beside it, rather
than print a result."""

import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["--workload", "refseq-k31.illumina150", "--seed", "2147483711", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "gpubench/run.py", *ARGS], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=300)
    return p.returncode, p.stdout


def test_no_card_no_result():
    rc, out = _run(ROOT)
    assert rc != 0 and "{" not in out


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("_data", "_cache", "__pycache__"))
    rc, out = _run(tmp_path)
    assert rc != 0 and "{" not in out
