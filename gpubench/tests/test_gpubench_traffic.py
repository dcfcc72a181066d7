"""The traffic generator gives every seed the same work, each mix names a
source (or says it assumed) for every parameter, and the host probe reads."""

import glob
import json
import os

import numpy as np
import pytest

from conftest import ROOT

PARAMS = ("read_len", "reads_per_sample", "foreign_share", "log_mu", "log_sigma", "substitution_rate", "n_rate")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "gpubench", "traffic", "*.json"))),
                         ids=os.path.basename)
def test_every_parameter_has_a_source(path):
    t = json.load(open(path))
    for p in PARAMS:
        assert p in t and (p in t["sources"]) != (p in t["assumed"]), p


def test_species_reads_fixed_and_log_normal():
    from gpubench.synth import reads

    t = {"log_mu": 1.0, "log_sigma": 2.0}
    c = reads.species_reads(t, 400, 112500)
    assert c.sum() == 112500 and np.all(np.diff(c) <= 0)
    assert np.array_equal(c, reads.species_reads(t, 400, 112500))
    # log-normal's spread: the largest share over the median's is e^(2 sigma z) at the top quantile
    assert 100 < c[0] / c[200] < 1000


@pytest.mark.parametrize("seed", [0, 2147483647 + 12345])
def test_seed_draws_the_reads_not_their_number(seed):
    from gpubench.synth import reads

    genomes = np.random.default_rng(1).integers(0, 4, (20, 1000), dtype=np.uint8)
    t = {"read_len": 150, "reads_per_sample": 3000, "foreign_share": 0.1, "log_mu": 1.0, "log_sigma": 2.0,
         "substitution_rate": 0.001, "n_rate": 0.001}
    a, b = reads.make(t, genomes, seed), reads.make(t, genomes, seed + 1)
    assert a.codes.shape == b.codes.shape == (3000, 150)
    assert not np.array_equal(a.codes, b.codes)
    assert np.array_equal(a.codes, reads.make(t, genomes, seed).codes)


def test_host_probe_reads():
    from gpubench import hostprobe

    m = hostprobe.measure()
    assert set(m) == {f"{n}{s}" for n in ("unique", "sort", "touch", "python") for s in ("_s", "_cpu_s")}
    assert all(v >= 0 for v in m.values()) and m["sort_s"] > 0
