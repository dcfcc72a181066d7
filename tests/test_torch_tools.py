"""The port's host tools (krakenuniq_tpu_torch.cli.tools) against the JAX
package's and the reference goldens: each of the 13 `*_main` functions runs
in both packages on the same argv, and its standard output and the files it
writes must be byte-equal (tolerance 0: every output is text or integers),
and equal to the golden where the fixture has one."""

import io
import os
import shutil
import sys

import numpy as np
import pytest

from krakenuniq_tpu.cli import tools as jax_tools
from krakenuniq_tpu_torch.cli import tools as torch_tools

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "query_taxdb.out")), reason="golden fixture missing"
)


def run_main(fn, argv, stdin_text=""):
    out = io.StringIO()
    old_out, old_in = sys.stdout, sys.stdin
    sys.stdout, sys.stdin = out, io.StringIO(stdin_text)
    try:
        rc = fn(argv)
    finally:
        sys.stdout, sys.stdin = old_out, old_in
    return rc, out.getvalue()


def golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def graded_kraken(path):
    """kraken.out with each read renamed to the randomreads convention (six
    underscores, then the seqid; tests/test_grade.py)."""
    with open(os.path.join(DATA, "kraken.out")) as f, open(path, "w") as out:
        for line in f.read().splitlines():
            fields = line.split("\t")
            taxid = fields[1].split("_tax")[1] if fields[1].startswith("read") else "311"
            fields[1] = f"a_b_c_d_e_f_seq_{taxid}"
            out.write("\t".join(fields) + "\n")


def v1_database(db):
    """The golden database laid out in v1 (plain minimizer) order under a v1
    index, as an upgrade's input."""
    from krakenuniq_tpu_torch.formats import read_index, read_kdb, write_index, write_kdb
    from krakenuniq_tpu_torch.utils.bits import bin_key

    hdr, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    _, nt, _ = read_index(os.path.join(DATA, "database.idx"))
    b1 = bin_key(np.asarray(keys), hdr.k, nt, xor_mask=0)
    order = np.lexsort((keys, b1))
    os.makedirs(db)
    write_kdb(os.path.join(db, "database.kdb"), np.asarray(keys)[order], np.asarray(vals)[order], k=hdr.k)
    counts = np.bincount(b1[order].astype(np.int64), minlength=4**nt)
    write_index(os.path.join(db, "database.idx"), nt,
                np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64), idx_type=1)


K = os.path.join(DATA, "kraken.out")
LIB = os.path.join(DATA, "library.fna")

# (main, argv with {out} for the run's own directory, golden of stdout or
# None, files the run writes under {out} (with their goldens), a function
# giving stdin's text or "", setup)
CASES = {
    "report": ("report_main", ["--db", DATA, K], "postproc_report.tsv", {}, "", None),
    "report_show_zeros": ("report_main", ["--db", DATA, "--show-zeros", K], None, {}, "", None),
    "translate": ("translate_main", ["--db", DATA, K], "translate.txt", {}, "", None),
    "translate_mpa": ("translate_main", ["--db", DATA, "--mpa-format", K], "translate_mpa.txt", {}, "", None),
    "filter": ("filter_main", ["--db", DATA, "--threshold", "0.2", K], "filtered.out", {}, "", None),
    "filter_zero": ("filter_main", ["--db", DATA, K], None, {}, "", None),
    "mpa_report": ("mpa_report_main", ["--db", DATA, K], "mpa_report.tsv", {}, "", None),
    "mpa_report_flags": ("mpa_report_main", ["--db", DATA, "--show-zeros", "--header-line",
                                             "--intermediate-ranks", K, K], None, {}, "", None),
    "extract_21": ("extract_reads_main", ["-a", "21", K, os.path.join(DATA, "reads.fa")], "extract_21.fa", {},
                   "", None),
    "extract_21_subtree": ("extract_reads_main", ["-a", "-t", os.path.join(DATA, "taxDB"), "21", K,
                                                  os.path.join(DATA, "reads.fa")], "extract_21_subtree.fa", {},
                           "", None),
    "extract_311_fq": ("extract_reads_main", ["311", K, os.path.join(DATA, "reads.fq")], "extract_311.fq", {},
                       "", None),
    "extract_not311": ("extract_reads_main", ["-a", "-i", "311", K, os.path.join(DATA, "reads.fa")],
                       "extract_not311.fa", {}, "", None),
    "dump_taxdb": ("dump_taxdb_main", [os.path.join(DATA, "taxDB"), "{out}/names.dmp", "{out}/nodes.dmp"], None,
                   {"names.dmp": None, "nodes.dmp": None}, "", None),
    "query_taxdb": ("query_taxdb_main", [os.path.join(DATA, "taxDB"), "211", "311", "22", "1"], "query_taxdb.out",
                    {}, "", None),
    "query_taxdb_stdin": ("query_taxdb_main", [os.path.join(DATA, "taxDB")], None, {}, lambda: "211 311\n22 1\n",
                          None),
    "dump_db_kmers": ("dump_db_kmers_main", [os.path.join(DATA, "database.kdb")], None, {}, "", None),
    "count_unique": ("count_unique_main", ["-k", "21", "-p", "14"], "count_unique.out", {}, lambda: golden("library.fna"),
                     None),
    "read_uid_mapping": ("read_uid_mapping_main", [os.path.join(DATA, "uid_to_taxid.map")], None, {}, "", None),
    "read_uid_mapping_uids": ("read_uid_mapping_main", [os.path.join(DATA, "uid_to_taxid.map"), "1", "3", "7"],
                              None, {}, "", None),
    "upgrade_db": ("upgrade_db_main", ["{out}/db"], None,
                   {"db/database.kdb": "database.kdb", "db/database.idx": "database.idx",
                    "db/database.kdb.v1": None, "db/database.idx.v1": None}, "", v1_database),
    "grade": ("grade_main", [os.path.join(DATA, "taxDB"), os.path.join(DATA, "seqid2taxid.map"),
                             "{out}/kraken.renamed", "{out}/per_read.tsv"], None, {"per_read.tsv": None}, "",
              graded_kraken),
    "get_kmers": ("get_kmers_main", ["-d", os.path.join(DATA, "database.kdb"), "-m",
                                     os.path.join(DATA, "seqid2taxid.map"), "-F", LIB, "-o", "{out}/kmers.tsv"],
                  None, {"kmers.tsv": None}, "", None),
}

SETUP_ARG = {"upgrade_db": "db", "grade": "kraken.renamed"}


def run_case(pkg_tools, name, out_dir):
    fn_name, argv, _, files, stdin, setup = CASES[name]
    os.makedirs(out_dir)
    if setup is not None:
        setup(os.path.join(out_dir, SETUP_ARG[name]))
    rc, stdout = run_main(getattr(pkg_tools, fn_name), [a.replace("{out}", out_dir) for a in argv],
                          stdin() if stdin else "")
    written = {}
    for rel in files:
        with open(os.path.join(out_dir, rel), "rb") as f:
            written[rel] = f.read()
    return rc, stdout, written


@pytest.mark.parametrize("name", sorted(CASES))
def test_tool_matches_jax_and_golden(name, tmp_path):
    rc_j, out_j, files_j = run_case(jax_tools, name, str(tmp_path / "jax"))
    rc_t, out_t, files_t = run_case(torch_tools, name, str(tmp_path / "torch"))
    assert rc_t == rc_j == 0
    assert out_t == out_j
    assert files_t == files_j
    _, _, gold, files, _, _ = CASES[name]
    if gold is not None:
        if name == "count_unique":
            assert out_t.strip() == golden(gold).strip()
        else:
            assert out_t == golden(gold)
    for rel, g in files.items():
        if g is not None:
            with open(os.path.join(DATA, g), "rb") as f:
                assert files_t[rel] == f.read()
    assert out_t or files_t


def test_every_tool_main_is_covered():
    mains = sorted(n for n in dir(jax_tools) if n.endswith("_main"))
    assert mains == sorted(n for n in dir(torch_tools) if n.endswith("_main"))
    assert len(mains) == 13
    assert {c[0] for c in CASES.values()} == set(mains)


def test_tool_errors_match_jax(capsys):
    """The argument checks return the same codes (the messages name each
    package's program)."""
    for pkg in (jax_tools, torch_tools):
        assert pkg.report_main(["--db", DATA, "--taxon-counts", "--taxon-list", K]) == 64
        assert pkg.filter_main(["--db", DATA, "--threshold", "1.5", K]) == 64


def test_upgrade_db_is_idempotent(tmp_path):
    db = str(tmp_path / "db")
    v1_database(db)
    assert run_main(torch_tools.upgrade_db_main, [db])[0] == 0
    before = open(os.path.join(db, "database.kdb"), "rb").read()
    assert run_main(torch_tools.upgrade_db_main, [db])[0] == 0
    assert open(os.path.join(db, "database.kdb"), "rb").read() == before
    shutil.rmtree(db)


def test_console_scripts_mirror_the_jax_packages():
    """pyproject.toml names a krakenuniq-tpu-torch-<tool> script for each of
    the JAX package's krakenuniq-tpu-<tool> scripts, on the port's function
    of the same name."""
    import importlib
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    jax_scripts = {n: v for n, v in scripts.items() if v.startswith("krakenuniq_tpu.")}
    torch_scripts = {n: v for n, v in scripts.items() if v.startswith("krakenuniq_tpu_torch.")}
    assert len(jax_scripts) == 16
    want = {n.replace("krakenuniq-tpu", "krakenuniq-tpu-torch", 1): v.replace("krakenuniq_tpu.", "krakenuniq_tpu_torch.", 1)
            for n, v in jax_scripts.items()}
    assert torch_scripts == want
    for target in torch_scripts.values():
        module, fn = target.split(":")
        assert callable(getattr(importlib.import_module(module), fn))
