"""The control (control.py: the reference in the program's place, matching
k-mers on 32-bit fingerprints of their hash instead of on all their bits)
fails the check that sound runs pass."""

import os

import numpy as np

from conftest import run_toy, toy_cell


def test_control_fails_the_check(bench, data_dir):
    from gpubench import control
    from gpubench.synth import database, reads as synth_reads

    out = run_toy(bench, "refseq-k31.illumina150", data_dir, 2147483719)
    assert out["correct"]
    _, config, traffic = toy_cell(bench, "refseq-k31.illumina150")
    # enough keys that 32-bit fingerprints collide on some reads' k-mers
    config = dict(config, database="toy-wide", keys=3_000_000)
    spec = {key: config[key] for key in ("k", "minimizer_len", "species", "genome_len", "species_per_genus",
                                         "divergence", "keys", "taxonomy_nodes", "db_seed")}
    spec["name"] = config["database"]
    db_dir, _ = database.ensure(spec, data_dir, "cpu")
    reads = synth_reads.make(traffic, np.load(os.path.join(db_dir, "genomes.npy")), 2147483719)
    got = control.readings(db_dir, reads)
    assert got["kraken_lines_differing"] > 0 and got["report_rows_differing"] > 0
