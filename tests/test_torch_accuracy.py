"""The port's accuracy loop (utils/simulate.py, report/grade.py,
report/accuracy.py) against the JAX package's on the golden library: the
same seed gives the same reads name for name, and simulate_and_grade with
ClassifyOptions(device="cpu") writes the same reads, kraken output, per-read
table and stats (byte for byte) and meets tests/test_simulated_accuracy.py's
bounds."""

import functools
import io
import os

import pytest

from krakenuniq_tpu.utils import simulate as jax_sim
from krakenuniq_tpu_torch.utils import simulate as torch_sim

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
LIB = os.path.join(DATA, "library.fna")

pytestmark = pytest.mark.skipif(not os.path.exists(LIB), reason="golden fixture missing")


def library():
    from krakenuniq_tpu_torch.formats.seqio import read_sequences

    return {d.id: d.seq for d in read_sequences(LIB)}


@pytest.mark.parametrize("n,read_len,error_rate,seed,both", [
    (300, 100, 0.0, 1, True),
    (300, 100, 0.02, 3, True),
    (200, 150, 0.1, 7, False),
    (50, 1000, 0.05, 11, True),
])
def test_simulate_reads_matches_jax(n, read_len, error_rate, seed, both):
    seqs = library()
    got = torch_sim.simulate_reads(seqs, n, read_len, error_rate, seed, both_strands=both)
    assert got == jax_sim.simulate_reads(seqs, n, read_len, error_rate, seed, both_strands=both)
    assert len(got) == n and all(len(r) == read_len for _, r in got)


def test_simulate_reads_edges_match_jax(tmp_path):
    seqs = {"a_b": "ACGTacgtNN" * 5, "short": "ACG", "c": "TTTTGGGGCCCCAAAA" * 3}
    for rl in (10, 48, 50):
        assert torch_sim.simulate_reads(seqs, 40, rl, 0.2, 5) == jax_sim.simulate_reads(seqs, 40, rl, 0.2, 5)
    with pytest.raises(ValueError, match="no sequence"):
        torch_sim.simulate_reads(seqs, 5, 51)
    assert torch_sim.revcomp("ACGTNacgt") == jax_sim.revcomp("ACGTNacgt")
    for mod, name in ((jax_sim, "jax.fa"), (torch_sim, "torch.fa")):
        assert mod.write_simulated_fasta(str(tmp_path / name), seqs, 30, 20, 0.05, 9) == 30
    assert (tmp_path / "torch.fa").read_bytes() == (tmp_path / "jax.fa").read_bytes()


@functools.lru_cache(maxsize=None)
def _loop(pkg, root, error_rate, n_reads, seed):
    if pkg == "jax":
        from krakenuniq_tpu.report.accuracy import simulate_and_grade

        opts = None
    else:
        from krakenuniq_tpu_torch.classify import ClassifyOptions
        from krakenuniq_tpu_torch.report.accuracy import simulate_and_grade

        opts = ClassifyOptions(device="cpu", print_progress=False)
    work = os.path.join(root, f"{pkg}_{error_rate}_{n_reads}_{seed}")
    stats, files = simulate_and_grade(DATA, work, library_fastas=[LIB], n_reads=n_reads, read_len=100,
                                      error_rate=error_rate, seed=seed, classify_options=opts)
    data = {}
    for key, path in files.items():
        with open(path, "rb") as f:
            data[key] = f.read()
    return stats, data


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("accuracy"))


LOOPS = [(0.0, 400, 3), (0.02, 400, 3), (0.01, 300, 11)]


@pytest.mark.parametrize("error_rate,n_reads,seed", LOOPS)
@pytest.mark.parametrize("key", ["reads", "kraken", "per_read", "stats"])
def test_simulate_and_grade_matches_jax(root, key, error_rate, n_reads, seed):
    stats_t, got = _loop("torch", root, error_rate, n_reads, seed)
    stats_j, want = _loop("jax", root, error_rate, n_reads, seed)
    assert got[key] == want[key] and got[key]
    assert repr(stats_t) == repr(stats_j)  # nan precision compares by its text


def test_accuracy_bounds_error_free(root):
    """tests/test_simulated_accuracy.py:37-51's bounds."""
    stats, data = _loop("torch", root, 0.0, 400, 3)
    assert stats["total_reads"] == 400
    assert stats["unidentified"] <= 4
    assert stats["sensitivity"]["species"] >= 85.0
    assert stats["precision"]["species"] >= 99.0
    assert stats["sensitivity"]["genus"] >= stats["sensitivity"]["species"]
    assert data["stats"].decode().count("#rank") == 2


def test_accuracy_bounds_with_errors(root):
    """tests/test_simulated_accuracy.py:53-60's bounds at 2% substitution
    errors."""
    stats, _ = _loop("torch", root, 0.02, 400, 3)
    assert stats["sensitivity"]["species"] >= 75.0
    assert stats["precision"]["species"] >= 98.0


def test_grade_matches_jax_on_golden(tmp_path):
    """grade() on the golden kraken output renamed to the randomreads
    convention (tests/test_grade.py), with unmapped and unknown seqids."""
    from krakenuniq_tpu.report.grade import grade as jax_grade
    from krakenuniq_tpu_torch.report.grade import grade as torch_grade
    from tests.test_torch_tools import graded_kraken

    path = str(tmp_path / "kraken.renamed")
    graded_kraken(path)
    with open(path, "a") as f:
        f.write("C\ta_b_c_d_e_f_seq_nomap\t211\t100\t211:80\n")
        f.write("C\tshort_name\t211\t100\t211:80\n\n")
    outs = []
    for fn in (jax_grade, torch_grade):
        per_read, stats = io.StringIO(), io.StringIO()
        res = fn(os.path.join(DATA, "taxDB"), os.path.join(DATA, "seqid2taxid.map"), path, per_read, stats)
        outs.append((res, per_read.getvalue(), stats.getvalue()))
    assert outs[1] == outs[0]
    assert outs[1][0]["total_reads"] == 144


def test_seqmap_round_trip_matches_jax(tmp_path):
    from krakenuniq_tpu.formats.seqmap import read_seqid2taxid as jax_read
    from krakenuniq_tpu_torch.formats.seqmap import read_seqid2taxid, write_seqid2taxid

    m = read_seqid2taxid(os.path.join(DATA, "seqid2taxid.map"))
    assert m == jax_read(os.path.join(DATA, "seqid2taxid.map")) and m
    write_seqid2taxid(tmp_path / "m.map", {**m, "x y": 7})
    assert read_seqid2taxid(tmp_path / "m.map") == {**m, "x y": 7}
