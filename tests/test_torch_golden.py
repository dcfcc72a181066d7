"""Golden differential tests of the port: krakenuniq_tpu_torch's Classifier
(device="cpu") and CLI against the compiled reference binaries' outputs in
tests/golden/data, byte for byte."""

import io
import os

import pytest

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions
from krakenuniq_tpu_torch.cli.main import main as cli_main

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _run(reads, dbs=(".",), **opts):
    c = Classifier(
        [os.path.join(DATA, d) for d in dbs],
        ClassifyOptions(print_progress=False, device="cpu", **opts),
    )
    kraken, classified, unclassified = io.StringIO(), io.StringIO(), io.StringIO()
    c.run([os.path.join(DATA, reads)], kraken, classified, unclassified)
    report = io.StringIO()
    c.write_report(report)
    return {
        "kraken": kraken.getvalue(),
        "classified": classified.getvalue(),
        "unclassified": unclassified.getvalue(),
        "report": report.getvalue(),
    }


# (reads, databases, options, {output: golden file})
CASES = {
    "fasta": ("reads.fa", (".",), {}, {
        "kraken": "kraken.out", "classified": "classified.fa",
        "unclassified": "unclassified.fa", "report": "report.tsv",
    }),
    "fastq": ("reads.fq", (".",), {}, {"kraken": "kraken_fq.out", "report": "report_fq.tsv"}),
    "quick": ("reads.fa", (".",), {"quick": True, "min_hits": 2}, {"kraken": "kraken_quick.out"}),
    "p14": ("reads.fa", (".",), {"hll_precision": 14}, {
        "kraken": "kraken_p14.out", "report": "report_p14.tsv",
    }),
    "only_classified": ("reads.fa", (".",), {"only_classified_output": True}, {
        "kraken": "kraken_onlyc.out",
    }),
    "hierarchical": ("reads.fa", ("db_bact", "db_viral"), {}, {
        "kraken": "kraken_hier.out", "report": "report_hier.tsv",
    }),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classifier_matches_golden(case):
    reads, dbs, opts, goldens = CASES[case]
    got = _run(reads, dbs, **opts)
    for key, name in goldens.items():
        assert got[key] == _golden(name), f"{case}: {key} differs from {name}"


def test_cli_paired_matches_golden(tmp_path):
    out = tmp_path / "kraken.out"
    rc = cli_main([
        "--db", DATA, "--paired", "--device", "cpu", "--output", str(out),
        os.path.join(DATA, "reads_r1.fq"), os.path.join(DATA, "reads_r2.fq"),
    ])
    assert rc == 0
    assert out.read_text() == _golden("kraken_paired.out")


def test_cli_report_body_matches_golden(tmp_path):
    out, rep = tmp_path / "kraken.out", tmp_path / "report.tsv"
    rc = cli_main([
        "--db", DATA, "--device", "cpu", "--output", str(out), "--report-file", str(rep),
        os.path.join(DATA, "reads.fa"),
    ])
    assert rc == 0
    assert out.read_text() == _golden("kraken.out")
    # the CLI prepends its two-line provenance header (scripts/krakenuniq:242-247)
    lines = rep.read_text().splitlines(keepends=True)
    assert lines[0].startswith("# KrakenUniq-TPU-torch") and lines[1].startswith("# CL:")
    assert "".join(lines[2:]) == _golden("report.tsv")


def test_long_read_names_the_later_slice(tmp_path):
    reads = tmp_path / "long.fa"
    reads.write_text(">long\n" + "ACGT" * 9000 + "\n")
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu"))
    with pytest.raises(NotImplementedError, match="long-read route"):
        c.run([str(reads)], io.StringIO())
