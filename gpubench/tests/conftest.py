"""CPU tests of the benchmark at a toy size: run with
`python -m pytest gpubench/tests -q` from the root of the checkout. None
needs a card."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the toy database: the configurations' shapes (k = 31, four species a
# genus, 5% divergence) at a few thousand keys
TOY = {"database": "toy", "minimizer_len": 7, "species": 8, "genome_len": 3000, "keys": 60000,
       "taxonomy_nodes": 200}
TOY_READS = {"reads_per_sample": 8000, "warmup_reads": 2000}


@pytest.fixture(scope="session")
def bench():
    from gpubench import harness

    return harness


@pytest.fixture(scope="session")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gpubench_data"))


def toy_cell(harness, workload: str):
    """The workload's configuration and traffic, cut to the toy size."""
    man = harness.manifest()
    cell, config, traffic = harness.resolve_cell(man, workload)
    classify = dict(config["classify"])
    if classify.get("preload_size"):
        classify["preload_size"] = 256 << 10  # a few chunk tables of the toy table
    return cell, dict(config, classify=classify, **TOY), dict(traffic, **TOY_READS)


def run_toy(harness, workload: str, data_dir: str, seed: int, trace: bool = False, passes_s: float = 0.0):
    cell, config, traffic = toy_cell(harness, workload)
    metrics = harness.cell_metrics(harness.manifest(), workload, trace)
    return harness.run_cell(cell, config, traffic, metrics, seed, passes_s, trace, time.perf_counter(),
                            device="cpu", data_dir=data_dir)
