"""The port's database build (krakenuniq_tpu_torch.cli.build_main with
`--device cpu`, build/db_build.py, build/uid_build.py) against the JAX
package's and the goldens: the same library, taxonomy and flags in both
packages give byte-equal database files (tolerance 0), the same step-6b
self-classification, and the same build log, stamps aside."""

import functools
import os
import re
import shutil

import numpy as np
import pytest

from krakenuniq_tpu.cli.build_main import main as jax_build
from krakenuniq_tpu_torch.cli.build_main import main as torch_build

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")
BASE = ["--kmer-len", "21", "--minimizer-len", "7"]

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "library.fna")), reason="golden fixture missing"
)


def setup_db_dir(root):
    """A reference-layout database directory (tests/test_build_cli.py)."""
    db = os.path.join(root, "DB")
    os.makedirs(os.path.join(db, "library"))
    shutil.copy(os.path.join(DATA, "library.fna"), os.path.join(db, "library"))
    shutil.copy(os.path.join(DATA, "seqid2taxid.map"), os.path.join(db, "library", "library.map"))
    shutil.copytree(os.path.join(DATA, "taxonomy"), os.path.join(db, "taxonomy"))
    return db


def build(pkg, db, argv):
    if pkg == "torch":
        return torch_build(["--db", db, *argv, "--device", "cpu"])
    return jax_build(["--db", db, *argv])


def products(root):
    """Every file a build left under root, by relative path: the report
    without its provenance header (it names the program and the date), the
    log without its stamps and with the port's program names as the JAX
    package's and root's path as <root>, and no table caches (each package
    keeps its own)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if ".kdb.ht" in name:
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith("report.tsv"):
                data = b"".join(l for l in data.splitlines(keepends=True) if not l.startswith(b"#"))
            if name == "database-build.log":
                data = re.sub(rb"(?m)^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\t", b"", data)
                data = data.replace(b"krakenuniq-tpu-torch", b"krakenuniq-tpu").replace(root.encode(), b"<root>")
            out[rel] = data
    return out


@functools.lru_cache(maxsize=None)
def _built(root, pkg):
    db = setup_db_dir(os.path.join(root, pkg))
    assert build(pkg, db, BASE) == 0
    with open(os.path.join(db, "database-build.log")) as f:
        log = f.read()
    return db, products(db), log


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("builds"))
    return _built(root, "jax"), _built(root, "torch")


@pytest.mark.parametrize("name", ["database.kdb", "database.idx", "database.kdb.counts", "taxDB"])
def test_build_outputs_match_jax_and_golden(both, name):
    (_, want, _), (_, got, _) = both
    assert got[name] == want[name]
    if name != "database.kdb.counts":
        with open(os.path.join(DATA, name), "rb") as f:
            assert got[name] == f.read()


@pytest.mark.parametrize("name", ["database.kraken.tsv", "database.report.tsv", "seqid2taxid.map"])
def test_step_6b_matches_jax(both, name):
    """Step 6b's self-classification: the kraken output and the report's
    body (its provenance header names the program) as the JAX build's."""
    (_, want, _), (db, got, _) = both
    assert got[name] == want[name] and got[name]
    with open(os.path.join(db, "database.report.tsv")) as f:
        assert f.readline().startswith("# KrakenUniq-TPU-torch")


def test_build_log_holds_the_same_steps(both):
    (_, want, _), (_, got, log) = both
    assert got["database-build.log"] == want["database-build.log"]
    stamp = re.compile(r"^\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\t\S")
    lines = log.splitlines()
    assert len(lines) == 6 and all(stamp.match(line) for line in lines)
    assert "krakenuniq-tpu-torch --preload" in lines[4]
    assert set(got) == set(want)


def test_restart_skips_finished_steps(tmp_path):
    """A rerun skips every finished step: the log gains only its last line,
    and no product changes."""
    db = setup_db_dir(str(tmp_path))
    assert build("torch", db, BASE) == 0
    before = products(db)
    assert build("torch", db, BASE) == 0
    after = products(db)
    log_before = before.pop("database-build.log").splitlines()
    log_after = after.pop("database-build.log").splitlines()
    assert after == before
    assert log_after == log_before + [b"database build complete"]


def run_task(pkg, root, argv, before=None):
    """Build, then run a task (argv with {db} and {root}); returns the rc
    of each call and every product under root."""
    db = setup_db_dir(root)
    rcs = []
    if before is not None:
        rcs.append(build(pkg, db, before))
    for a in argv:
        rcs.append(build(pkg, db, [x.replace("{db}", db).replace("{root}", root) for x in a]))
    return rcs, products(root)


TASKS = {
    "taxids_for_sequences": (None, [BASE + ["--taxids-for-sequences"]]),
    "taxids_for_genomes": (None, [BASE + ["--taxids-for-genomes", "--taxids-for-sequences"]]),
    "max_db_size": (None, [BASE + ["--max-db-size", "0.00002"]]),
    "shrink": (BASE, [["--minimizer-len", "7", "--shrink", "500"],
                      ["--minimizer-len", "7", "--shrink", "0", "--new-db", "{root}/small"],
                      ["--minimizer-len", "7", "--shrink", "500", "--new-db", "{root}/small"],
                      ["--minimizer-len", "7", "--shrink", "500", "--new-db", "{root}/small"]]),
    "rebuild_and_clean": (BASE, [BASE + ["--rebuild"], ["--clean"]]),
    "min_contig_size": (None, [BASE + ["--min-contig-size", "3000"]]),
    "bad_lengths": (None, [["--kmer-len", "40"], ["--kmer-len", "21", "--minimizer-len", "21"]]),
    "build_memory": (None, [BASE + ["--build-memory", "64K"]]),
}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_build_task_matches_jax(task, tmp_path):
    before, argv = TASKS[task]
    rcs_j, want = run_task("jax", str(tmp_path / "jax"), argv, before)
    rcs_t, got = run_task("torch", str(tmp_path / "torch"), argv, before)
    assert rcs_t == rcs_j
    assert got == want


def test_build_memory_streams_the_in_ram_database(tmp_path):
    """A streaming build under a tiny --build-memory (many pair buckets)
    writes the in-RAM build's files."""
    from krakenuniq_tpu_torch.build import build_database
    from krakenuniq_tpu_torch.build.db_build import _plan_buckets
    from krakenuniq_tpu_torch.formats import write_index, write_kdb
    from krakenuniq_tpu_torch.formats.seqmap import read_seqid2taxid
    from krakenuniq_tpu_torch.taxonomy import Taxonomy

    lib = [os.path.join(DATA, "library.fna")]
    assert _plan_buckets(lib, 64 << 10) > 8
    db = setup_db_dir(str(tmp_path))
    assert build("torch", db, BASE + ["--build-memory", "64K"]) == 0
    res = build_database(lib, read_seqid2taxid(os.path.join(DATA, "seqid2taxid.map")),
                         Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB")), k=21, nt=7)
    write_kdb(tmp_path / "ram.kdb", res.keys, res.vals, k=21)
    write_index(tmp_path / "ram.idx", 7, res.offsets)
    for a, b in (("database.kdb", "ram.kdb"), ("database.idx", "ram.idx")):
        with open(os.path.join(db, a), "rb") as f, open(tmp_path / b, "rb") as g:
            assert f.read() == g.read()


def test_reset_taxids_matches_jax(tmp_path):
    """--reset-taxids reruns the LCA step over an existing database.kdb
    whose values were corrupted, in both packages."""
    outs = {}
    for pkg in ("jax", "torch"):
        db = setup_db_dir(str(tmp_path / pkg))
        assert build(pkg, db, BASE) == 0
        path = os.path.join(db, "database.kdb")
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        assert build(pkg, db, BASE) == 0
        kept = open(path, "rb").read()
        assert kept == bytes(raw)
        assert build(pkg, db, BASE + ["--reset-taxids"]) == 0
        outs[pkg] = products(db)
    assert outs["torch"] == outs["jax"]
    with open(os.path.join(DATA, "database.kdb"), "rb") as f:
        assert outs["torch"]["database.kdb"] == f.read()


def test_lca_order_matches_jax(tmp_path):
    """--lca-order: the viral genome as a later priority group overrides
    the values of its k-mers (build_db.sh:279-301)."""
    from krakenuniq_tpu_torch.formats.seqio import read_sequences

    outs = {}
    for pkg in ("jax", "torch"):
        db = setup_db_dir(str(tmp_path / pkg))
        viral = os.path.join(db, "library", "viral")
        os.makedirs(viral)
        with open(os.path.join(viral, "viral.fna"), "w") as f:
            for dna in read_sequences(os.path.join(DATA, "library.fna")):
                if dna.id == "seq_311":
                    f.write(f">{dna.id}\n{dna.seq}\n")
        assert build(pkg, db, BASE + ["--lca-order", "viral"]) == 0
        assert build(pkg, str(tmp_path / pkg / "bad"), BASE + ["--lca-order", "nothing"]) == 1
        outs[pkg] = products(db)
    got, want = outs["torch"], outs["jax"]
    # step 6b reads library.fna (multi-line FASTA: the span route's fallback
    # chunk) and then viral/viral.fna. The port writes their lines in input
    # order, as KrakenUniq does; the JAX CLI writes the span route's lines
    # to the file's buffer past the text lines still in its wrapper, so
    # viral.fna's line comes first there (F8, ROADMAP §3)
    kraken = got.pop("database.kraken.tsv").splitlines(keepends=True)
    want_kraken = want.pop("database.kraken.tsv").splitlines(keepends=True)
    assert [line.split(b"\t")[1] for line in kraken] == [
        b"seq_211", b"seq_212", b"seq_221", b"seq_222", b"seq_311", b"seq_311"]
    assert want_kraken == kraken[-1:] + kraken[:-1]
    assert got == want


def test_upgrade_task_matches_jax_and_golden(tmp_path):
    """--upgrade re-sorts a v1 database to the v2 scrambled order."""
    from tests.test_torch_tools import v1_database

    outs = {}
    for pkg in ("jax", "torch"):
        db = str(tmp_path / pkg / "V1DB")
        v1_database(db)
        assert build(pkg, db, ["--upgrade"]) == 0
        assert build(pkg, db, ["--upgrade"]) == 0
        outs[pkg] = products(db)
    assert outs["torch"] == outs["jax"]
    for name in ("database.kdb", "database.idx"):
        with open(os.path.join(DATA, name), "rb") as f:
            assert outs["torch"][name] == f.read()


def test_uid_database_matches_golden_and_jax(tmp_path):
    """--uid-database writes the golden uid_database.kdb and
    uid_to_taxid.map, as does the JAX package's build_uid_database."""
    from krakenuniq_tpu.build.uid_build import build_uid_database as jax_uid
    from krakenuniq_tpu_torch.build.uid_build import build_uid_database as torch_uid
    from krakenuniq_tpu_torch.formats import read_index, read_kdb
    from krakenuniq_tpu_torch.formats.seqmap import read_seqid2taxid

    db = setup_db_dir(str(tmp_path / "torch"))
    assert build("torch", db, BASE + ["--uid-database"]) == 0
    got = products(db)
    for name in ("uid_database.kdb", "uid_to_taxid.map"):
        with open(os.path.join(DATA, name), "rb") as f:
            assert got[name] == f.read()
    _, keys, _ = read_kdb(os.path.join(DATA, "database.kdb"))
    _, nt, offsets = read_index(os.path.join(DATA, "database.idx"))
    seqmap = read_seqid2taxid(os.path.join(DATA, "seqid2taxid.map"))
    lib = [os.path.join(DATA, "library.fna")]
    outs = {}
    for name, fn in (("jax", jax_uid), ("torch", torch_uid)):
        d = tmp_path / f"uid_{name}"
        d.mkdir()
        n = fn(lib, seqmap, np.asarray(keys), 21, nt, offsets, str(d), min_sequence_size=0)
        outs[name] = (n, products(str(d)))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == {n: got[n] for n in ("uid_database.kdb", "uid_to_taxid.map",
                                                     "uid_database.kdb.counts")}


def test_standard_and_download_dispatch_match_jax(tmp_path, monkeypatch):
    """--standard and --download-taxonomy / --download-library run the
    download through the offline fetcher (tests/test_build_cli.py); the
    build that --standard chains writes the JAX build's database. The port
    keeps KrakenUniq's default assembly level (F4), so its refseq domains
    hold the Complete Genome assembly only; the Scaffold one the JAX
    package also fetches holds no k-mer (4 bp)."""
    import krakenuniq_tpu.build.download as jax_dl
    import krakenuniq_tpu_torch.build.download as torch_dl
    from tests.test_build_cli import _standard_fetcher

    monkeypatch.setattr(jax_dl, "_default_fetch", _standard_fetcher())
    monkeypatch.setattr(torch_dl, "_default_fetch", _standard_fetcher())
    outs = {}
    for pkg in ("jax", "torch"):
        db = str(tmp_path / pkg / "STD")
        assert build(pkg, db, ["--standard", *BASE]) == 0
        dl = str(tmp_path / pkg / "DL")
        assert build(pkg, dl, ["--download-taxonomy"]) == 0
        assert build(pkg, dl, ["--download-library", "contaminants"]) == 0
        outs[pkg] = products(str(tmp_path / pkg))
    got, want = outs["torch"], outs["jax"]
    scaffold = set(want) - set(got)
    assert scaffold == {f"STD/library/{d}/GCF_002_ASM2_genomic.{e}" for d in ("archaea", "bacteria")
                        for e in ("fna", "map")}
    assert "STD/library/viral/GCF_002_ASM2_genomic.fna" in got  # refseq/viral/Any names its level
    assert "DL/database.kdb" not in got and "DL/library/contaminants/UniVec.map" in got
    assert set(got) == set(want) - scaffold
    # the two Scaffold sequences are 4 bp: two more library files and two
    # more unclassified reads in the JAX package's step 6b, and nothing else
    h = b"h9606\t"
    differ = {p for p in got if got[p] != want[p]}
    assert differ == {f"STD/{n}" for n in ("seqid2taxid.map", "database.kraken.tsv", "database.report.tsv",
                                           "database-build.log")}
    assert sorted(want["STD/seqid2taxid.map"].splitlines()) == sorted(
        got["STD/seqid2taxid.map"].splitlines() + [h + b"9606"] * 2)
    rows_t, rows_j = got["STD/database.kraken.tsv"].splitlines(), want["STD/database.kraken.tsv"].splitlines()
    assert [r for r in rows_t if h not in r] == [r for r in rows_j if h not in r]
    assert sum(h in r for r in rows_j) == sum(h in r for r in rows_t) + 2
    assert got["STD/database-build.log"] == want["STD/database-build.log"].replace(b"9 library", b"7 library")
    report_t = [r.split(b"\t")[3:] for r in got["STD/database.report.tsv"].splitlines()]
    report_j = [r.split(b"\t")[3:] for r in want["STD/database.report.tsv"].splitlines()]
    assert report_t == report_j  # the k-mer columns; the read counts differ by the two reads
    for name in ("database.kdb", "database.idx", "database.kdb.counts", "taxDB"):
        assert got[f"STD/{name}"] == want[f"STD/{name}"]


SCANNER_CASES = [(31, 15, 0), (21, 7, 1), (31, 15, 2), (21, 7, 3)]


@pytest.mark.parametrize("k,nt,seed", SCANNER_CASES)
def test_native_scanner_matches_plain(k, nt, seed):
    """The build's scanner (the native module) against its plain version
    (numpy shift cascade, bin_key) on random sequences with N runs, other
    bytes, lower case and lengths around k."""
    from krakenuniq_tpu_torch.build import db_build

    rng = np.random.default_rng(seed)
    for length in (0, 1, k - 1, k, k + 1, 2 * k, 257, 5000):
        seq = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, size=length)].copy()
        for _ in range(int(rng.integers(0, 4))):
            if length:
                at = int(rng.integers(0, length))
                seq[at:at + int(rng.integers(1, 40))] = ord("N") if rng.random() < 0.7 else ord("R")
        text = seq.tobytes().decode()
        ks, bs = db_build._extract_kmers_bins(text, k, nt)
        kp, bp = db_build._extract_kmers_bins_plain(text, k, nt)
        assert ks.dtype == kp.dtype == np.uint64 and bs.dtype == bp.dtype
        np.testing.assert_array_equal(ks, kp)
        np.testing.assert_array_equal(bs, bp)


def test_scanner_raises_when_the_native_module_cannot_build(monkeypatch):
    """The build's path takes the native scanner or raises: the numpy plain
    version never takes its place."""
    from krakenuniq_tpu_torch import _native_build
    from krakenuniq_tpu_torch.build import db_build

    def fail():
        raise RuntimeError("building kuniq_native_torch failed (test)")

    monkeypatch.setattr(_native_build, "native", fail)
    with pytest.raises(RuntimeError, match="kuniq_native_torch failed"):
        db_build._extract_kmers_bins("ACGT" * 20, 21, 7)


def test_canonical_kmers_and_seq_taxid_match_jax():
    from krakenuniq_tpu.build import db_build as jax_db
    from krakenuniq_tpu_torch.build import db_build as torch_db

    rng = np.random.default_rng(9)
    seq = np.frombuffer(b"ACGTNacgtn", np.uint8)[rng.integers(0, 10, size=3000)].tobytes().decode()
    for k in (2, 15, 21, 31):
        np.testing.assert_array_equal(torch_db.extract_canonical_kmers(seq, k), jax_db.extract_canonical_kmers(seq, k))
    seqmap = {"a": 5, "b.x": 6, "c": 7}
    for sid in ("a", "a.1", "c.12", "b.x", "b.x.3", "kraken:taxid|123|z", "kraken:taxid|x", "zz", "c.1a"):
        assert torch_db.resolve_seq_taxid(sid, seqmap) == jax_db.resolve_seq_taxid(sid, seqmap)
