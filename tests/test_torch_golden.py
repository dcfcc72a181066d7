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
    """A read past max_read_len (32,768 bases by default) takes the
    long-read route, on the span route's fallback chunk and on the Python
    route: its kraken line is the reference oracle's (every k-mer's taxon,
    the host resolve of its hits)."""
    import reference_oracle as oracle

    from krakenuniq_tpu_torch.formats import read_kdb
    from krakenuniq_tpu_torch.formats.seqio import read_sequences
    from krakenuniq_tpu_torch.taxonomy import Taxonomy

    genomes = {d.id: d.seq for d in read_sequences(os.path.join(DATA, "library.fna"))}
    seq = (genomes["seq_211"] * 40)[:36_000]
    reads = tmp_path / "long.fa"
    reads.write_text(">long\n" + seq + "\n")
    k = 21
    _, keys, vals = read_kdb(os.path.join(DATA, "database.kdb"))
    kv = dict(zip(keys.tolist(), vals.tolist()))
    scan = oracle.scan_kmers(seq, k)
    taxa = [0 if amb else kv.get(oracle.canon(km, k), 0) for km, amb in scan]
    hits = {}
    for t in taxa:
        if t:
            hits[t] = hits.get(t, 0) + 1
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    call = oracle.resolve_tree(hits, tax.parent_map())
    want = (f"{'C' if call else 'U'}\tlong\t{call}\t{len(seq)}\t"
            f"{oracle.hitlist_string(taxa, [a for _, a in scan])}\n")
    for native in (True, False):
        c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", use_native=native))
        out = io.StringIO()
        c.run([str(reads)], out)
        assert out.getvalue() == want
        assert c.n_long_reads == 1
