"""The port's span route (krakenuniq_tpu_torch.classify.pipeline, native
parser, packed spans, RLE rows) on the CPU: byte-equal to the reference
binaries' goldens and to the port's Python host route, across chunk, work
unit and span boundaries, overflow rows, multi-line FASTA through the
fallback chunk, FASTQ, quick mode and --only-classified-output; the route
choice; the fetch slice of tail spans; the native build under concurrent
processes; and the CLI's reference-compatible flags and taxDB creation."""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.classify import pipeline
from krakenuniq_tpu_torch.cli.main import build_parser
from krakenuniq_tpu_torch.cli.main import main as cli_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several pytest-xdist workers on one host, whose torch thread pools
    would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _run(reads, dbs=(".",), **opts):
    c = Classifier(
        [os.path.join(DATA, d) for d in dbs],
        ClassifyOptions(print_progress=False, device="cpu", **opts),
    )
    kraken, classified, unclassified = io.StringIO(), io.StringIO(), io.StringIO()
    c.run([reads if os.path.isabs(reads) else os.path.join(DATA, reads)], kraken, classified,
          unclassified)
    report = io.StringIO()
    c.write_report(report)
    out = {
        "kraken": kraken.getvalue(),
        "classified": classified.getvalue(),
        "unclassified": unclassified.getvalue(),
        "report": report.getvalue(),
    }
    return c, out


# (reads, databases, options, {output: golden file})
CASES = {
    "fasta": ("reads.fa", (".",), {}, {
        "kraken": "kraken.out", "classified": "classified.fa",
        "unclassified": "unclassified.fa", "report": "report.tsv",
    }),
    "fastq": ("reads.fq", (".",), {}, {"kraken": "kraken_fq.out", "report": "report_fq.tsv"}),
    "quick": ("reads.fa", (".",), {"quick": True, "min_hits": 2}, {"kraken": "kraken_quick.out"}),
    "only_classified": ("reads.fa", (".",), {"only_classified_output": True}, {
        "kraken": "kraken_onlyc.out",
    }),
    "hierarchical": ("reads.fa", ("db_bact", "db_viral"), {}, {
        "kraken": "kraken_hier.out", "report": "report_hier.tsv",
    }),
}
# Small work units and spans and two run slots: unit and span boundaries
# are crossed many times and most reads take the overflow-row path; with
# "chunks" the native parser's byte chunks are small too, so units and
# records straddle chunk boundaries. The HLL estimates depend on the
# work-unit partition: away from the reference's 500 kbp units the report
# is held against the Python route's only.
SMALL = {"WORK_UNIT_SIZE": 1500, "SPAN_READS": 40, "MAX_RUNS": 2}


def _small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(pipeline, name, value)


@pytest.mark.parametrize("knobs", ["default", "units", "chunks"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_span_route_matches_golden_and_python_route(case, knobs, monkeypatch):
    reads, dbs, opts, goldens = CASES[case]
    if knobs != "default":
        _small(monkeypatch)
    if knobs == "chunks":
        monkeypatch.setattr(pipeline, "_CHUNK_BYTES", 2048)
    c, got = _run(reads, dbs, **opts)
    assert c.route == "span" and c.n_spans > 0 and c.n_units == 0
    if knobs != "default":
        assert c.n_spans >= 4
    c_py, ref = _run(reads, dbs, use_native=False, **opts)
    assert c_py.route == "python" and c_py.n_units > 0
    assert got == ref
    for key, name in goldens.items():
        if key in got and (knobs == "default" or key != "report"):
            assert got[key] == _golden(name), f"{case}: {key} differs from {name}"


def test_multiline_fasta_takes_the_fallback_chunk(tmp_path, monkeypatch):
    """Three records wrapped over lines: the chunks holding one go through
    the Python records, the others through spans, in read order."""
    lines = _golden("reads.fa").splitlines()
    recs = list(zip(lines[0::2], lines[1::2]))
    path = tmp_path / "wrapped.fa"
    with open(path, "w") as f:
        for i, (hdr, seq) in enumerate(recs):
            body = "\n".join(seq[j : j + 50] for j in range(0, len(seq), 50)) if i in (3, 70, 71) else seq
            f.write(f"{hdr}\n{body}\n")
    monkeypatch.setattr(pipeline, "_CHUNK_BYTES", 1024)
    _small(monkeypatch)
    c, got = _run(str(path))
    assert c.route == "span" and c.n_spans > 0 and c.n_units > 0
    assert got["kraken"] == _golden("kraken.out")
    assert got["classified"] == _golden("classified.fa")
    assert got == _run(str(path), use_native=False)[1]


@pytest.mark.parametrize(
    "opts,route",
    [({}, "span"), ({"value_pool": False}, "span"), ({"use_native": False}, "python"),
     ({"device_counters": True}, "span")],
    ids=["default", "dense-ids", "use-native-off", "device-counters"],
)
def test_route_choice(opts, route, capsys):
    """Only use_native=False takes the Python route; the span route
    serves device counters too, with no note."""
    c, got = _run("reads.fa", **opts)
    assert c.route == route
    assert (c.n_units == 0) == (route == "span")
    assert got["kraken"] == _golden("kraken.out") and got["report"] == _golden("report.tsv")
    assert "ROADMAP" not in capsys.readouterr().err


@pytest.mark.parametrize("b,n_span,rows", [(65536, 9000, 16384), (65536, 8192, 8192), (1024, 700, 1024)])
def test_tail_span_fetch_slice(b, n_span, rows):
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu"))
    out = {
        "packed": torch.zeros((b, 9), dtype=torch.int32),
        "hll_enc": torch.zeros((b, 3), dtype=torch.int32),
        "hll_dense": torch.zeros((b, 3), dtype=torch.int16),
        "taxa_dense": torch.zeros((b, 3), dtype=torch.int32),
    }
    host, evs = c._slice_and_prefetch(out, b, n_span)
    assert evs is None and sorted(host) == ["hll_dense", "hll_enc", "packed"]
    assert all(t.shape[0] == rows for t in host.values())


def test_native_build_is_safe_under_concurrent_processes(tmp_path):
    """Four processes build a fresh copy of the loader at once: one
    compiles, the others wait on the lock, and all load the same library."""
    from krakenuniq_tpu_torch import _native_build

    pkg = tmp_path / "pkg"
    (pkg / "native").mkdir(parents=True)
    shutil.copy(_native_build.__file__, pkg / "_native_build.py")
    shutil.copy(_native_build.SOURCE, pkg / "native" / "kuniq_native.cpp")
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('nb', sys.argv[1])\n"
        "nb = importlib.util.module_from_spec(spec); spec.loader.exec_module(nb)\n"
        "mod = nb.native()\n"
        "n, offs, multi = mod.parse_unit(b'>r1 x\\nACGT\\n>r2\\nGG\\n', False)\n"
        "print(mod.__file__, n)\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(pkg / "_native_build.py")],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    so, n = lines.pop().rsplit(" ", 1)
    assert n == "2" and os.path.dirname(so) == str(pkg / "_build")
    assert sorted(os.listdir(pkg / "_build")) == sorted([os.path.basename(so), "native.lock"])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from krakenuniq_tpu_torch import _native_build

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native_build, "SOURCE", str(bad))
    monkeypatch.setattr(_native_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="building kuniq_native_torch failed"):
        _native_build.build()
    assert not [f for f in os.listdir(tmp_path / "_build") if f.endswith(".tmp")]


def test_cli_writes_taxdb_from_dumps(tmp_path):
    """F1: taxDB missing, taxonomy/{names,nodes}.dmp present: the CLI
    writes taxDB from the dumps and classifies as with the golden taxDB."""
    db = tmp_path / "db"
    db.mkdir()
    for name in ("database.kdb", "database.idx", "database.kdb.counts"):
        shutil.copy(os.path.join(DATA, name), db / name)
    shutil.copytree(os.path.join(DATA, "taxonomy"), db / "taxonomy")
    out = tmp_path / "kraken.out"
    rc = cli_main(["--db", str(db), "--device", "cpu", "--output", str(out),
                   os.path.join(DATA, "reads.fa")])
    assert rc == 0
    assert (db / "taxDB").read_text() == _golden("taxDB")
    assert out.read_text() == _golden("kraken.out")


def test_cli_without_taxdb_or_dumps_fails(tmp_path, capsys):
    db = tmp_path / "db"
    db.mkdir()
    for name in ("database.kdb", "database.idx"):
        shutil.copy(os.path.join(DATA, name), db / name)
    assert cli_main(["--db", str(db), "--device", "cpu", os.path.join(DATA, "reads.fa")]) == 1
    assert "taxonomy dumps not found" in capsys.readouterr().err


@pytest.mark.parametrize(
    "env,argv,want",
    [("6", [], 6), ("many", [], None), ("", [], None), ("many", ["--threads", "3"], 3)],
    ids=["env", "env-not-a-number", "env-empty", "flag"],
)
def test_cli_threads_flag(env, argv, want, monkeypatch):
    """F2: --threads N with the KRAKEN_NUM_THREADS fallback; a value that
    is not a number is ignored instead of crashing the parser."""
    monkeypatch.setenv("KRAKEN_NUM_THREADS", env)
    args = build_parser().parse_args(["--db", DATA, *argv, "reads.fa"])
    assert args.threads == want


def test_cli_reference_command_line(tmp_path, monkeypatch):
    """F2: the reference wrapper's --threads and --preload are accepted and
    change nothing."""
    monkeypatch.setenv("KRAKEN_NUM_THREADS", "x")
    out = tmp_path / "kraken.out"
    rc = cli_main(["--db", DATA, "--threads", "4", "--preload", "--device", "cpu",
                   "--output", str(out), os.path.join(DATA, "reads.fa")])
    assert rc == 0 and out.read_text() == _golden("kraken.out")


def test_cli_preload_without_inputs(tmp_path):
    """F2: --preload with no input files loads the database and exits 0."""
    rep = tmp_path / "report.tsv"
    rc = cli_main(["--db", DATA, "--preload", "--device", "cpu", "--output", "off",
                   "--report-file", str(rep)])
    assert rc == 0 and rep.exists()
    assert cli_main(["--db", DATA, "--device", "cpu"]) == 1  # no inputs, no --preload


def test_overflow_rows_formatted_from_planes(monkeypatch):
    """With two run slots most golden reads overflow: their lines come from
    the device planes through kraken_lines, the rest from the RLE rows."""
    monkeypatch.setattr(pipeline, "MAX_RUNS", 2)
    c, got = _run("reads.fa")
    assert got["kraken"] == _golden("kraken.out")
    n_runs = np.array([len(line.split("\t")[4].split()) for line in got["kraken"].splitlines()])
    assert (n_runs > 2).sum() > 20 and (n_runs <= 2).sum() > 20


EDGE_INPUTS = {
    "empty.fa": b"",
    "header-only.fa": b">only",
    "no-final-newline.fa": b">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT",
    "shorter-than-k.fq": b"@q\nACGT\n+\nIIII\n",
    "lowercase-and-N.fa": b">x\nacgtnacgtacgtacgtacgtacgtacgtacgtacgtacgtacgt\n",
}


@pytest.mark.parametrize("name", sorted(EDGE_INPUTS) + ["reads.fa.gz"])
def test_span_route_edge_inputs_match_python_route(name, tmp_path):
    """Truncated, empty, short and gzipped inputs: the span route writes
    what the Python route writes."""
    path = tmp_path / name
    if name.endswith(".gz"):
        import gzip

        with open(os.path.join(DATA, "reads.fa"), "rb") as f, gzip.open(path, "wb") as g:
            g.write(f.read())
    else:
        path.write_bytes(EDGE_INPUTS[name])
    c, got = _run(str(path))
    assert c.route == "span"
    assert got == _run(str(path), use_native=False)[1]
    if name.endswith(".gz"):
        assert got["kraken"] == _golden("kraken.out")
