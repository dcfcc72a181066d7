"""The port's --exact counting and the remaining classify options on the CPU
against the JAX package, with exact equality: the canonical k-mer plane of
`kmer_front`'s plain versions and wrappers on both feeds, the exact span
step, and the runs of the JAX package's --exact tests
(tests/test_cli_features.py::test_exact_mode_native_path,
tests/test_device_counters.py::test_device_counters_exact_mode, the "exact"
case of tests/test_outofcore.py::test_ooc_matches_resident) through the
port's Classifier, on both routes, resident and out of core, with and
without --device-counters; then --print-sequence, --full-report,
report_zeros, true_hll_precision and min_batch_reads, and the CLI's
--exact, --print-sequence and --full-report, each byte-equal to the JAX
package's under the same options. The JAX runs are cached per module."""

import functools
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krakenuniq_tpu.classify import Classifier as JaxClassifier
from krakenuniq_tpu.classify import ClassifyOptions as JaxOptions
from krakenuniq_tpu.classify.device_step import classify_step
from krakenuniq_tpu.cli.main import main as jax_cli_main
from krakenuniq_tpu.kmer import ops as jkops
from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions, pipeline
from krakenuniq_tpu_torch.classify.device_step import (
    kmer_front,
    kmer_front_packed,
    kmer_front_plain,
    kmer_front_words,
    pack_input,
)
from krakenuniq_tpu_torch.cli.main import main as cli_main
from krakenuniq_tpu_torch.db import chunked
from krakenuniq_tpu_torch.formats.kdb import read_header
from krakenuniq_tpu_torch.taxonomy import Taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
READS = os.path.join(DATA, "reads.fa")
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _tiny_budget(frac=4):
    tax = Taxonomy.from_taxdb_file(os.path.join(DATA, "taxDB"))
    hdr = read_header(os.path.join(DATA, "database.kdb"))
    return max(1024, chunked.table_bytes(hdr.key_ct, tax.size - 1, False) // frac)


def _run(reads=READS, dbs=(DATA,), **opts):
    c = Classifier(list(dbs), ClassifyOptions(print_progress=False, device="cpu", **opts))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue(), c


@functools.lru_cache(maxsize=None)
def _jax_run_cached(reads, dbs, opts):
    c = JaxClassifier(list(dbs), JaxOptions(print_progress=False, **dict(opts)))
    kraken, report = io.StringIO(), io.StringIO()
    c.run([reads], kraken_fh=kraken)
    c.write_report(report)
    return kraken.getvalue(), report.getvalue()


def _both(reads=READS, dbs=(DATA,), **opts):
    """The port's run, byte-equal to the JAX package's under the same options
    (the JAX run cached per module); returns the port's (kraken, report,
    classifier)."""
    out, rep, c = _run(reads, dbs, **opts)
    want_out, want_rep = _jax_run_cached(reads, tuple(dbs), tuple(sorted(opts.items())))
    assert out == want_out
    assert rep == want_rep
    return out, rep, c


# ------------------------------------------------------- the canon plane


def _front_rows(k, b=48, lb=160, seed=0):
    """Random bases with ~3% N runs, padded as encode_batch pads; rows of
    length 0, k - 1, k and lb among them."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, lb), dtype=np.uint8)
    ambig = rng.random((b, lb)) < 0.03
    lengths = rng.integers(0, lb + 1, size=b)
    lengths[:4] = (0, k - 1, k, lb)
    pad = np.arange(lb)[None, :] >= lengths[:, None]
    ambig |= pad
    codes[ambig] = 0
    return codes, ambig


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("lb", [160, 170])
def test_kmer_front_canon_matches_jax(k, lb):
    """The canonical k-mers that kmer_front returns with canon=True, from the
    plain versions on both feeds and from the wrappers on CPU tensors, equal
    the JAX package's canonical_representation(pack_windows(codes, k)); the
    other three outputs are those of canon=False."""
    codes, ambig = _front_rows(k, lb=lb, seed=k + lb)
    want = np.asarray(jkops.canonical_representation(jkops.pack_windows(jnp.asarray(codes), k), k))
    c, a = T(codes), T(ambig)
    got = kmer_front_plain(c, a, k, 12, canon=True)
    assert len(got) == 4 and got[3].dtype == torch.int64
    np.testing.assert_array_equal(got[3].numpy().view(np.uint64), want)
    for x, y in zip(got[:3], kmer_front_plain(c, a, k, 12)):
        assert torch.equal(x, y)
    for x, y in zip(kmer_front(c, a, k, 12, canon=True), got):
        assert torch.equal(x, y)
    cw, aw = pack_input(c, a)
    lbp = 16 * cw.shape[1]
    packed = kmer_front_packed(cw, aw, lbp, k, 12, canon=True)
    np.testing.assert_array_equal(packed[3][:, : lb - k + 1].numpy().view(np.uint64), want)
    for x, y in zip(kmer_front_words(cw, aw, k, 12, canon=True), packed):
        assert torch.equal(x, y)
    assert len(kmer_front_words(cw, aw, k, 12)) == 3


EXACT_OUTPUTS = ("packed", "taxa", "ambig", "hll_lanes", "canon")


@pytest.mark.parametrize("quick", [False, True], ids=["resolve", "quick"])
def test_exact_span_step_matches_jax(quick):
    """The exact span config's step (the outputs the host reads: RLE rows,
    taxids, ambiguity, counted lanes, canonical k-mers) against the JAX
    package's exact span step on one span of the golden reads."""
    from krakenuniq_tpu_torch import _native_build

    kw = dict(exact=True, quick=quick, min_hits=2 if quick else 1)
    jc = JaxClassifier([DATA], JaxOptions(print_progress=False, **kw))
    c = Classifier([DATA], ClassifyOptions(print_progress=False, device="cpu", **kw))
    assert c._cfg_packed.outputs == jc._cfg_packed.outputs == EXACT_OUTPUTS
    with open(READS, "rb") as f:
        buf = f.read()
    _, offs, _ = _native_build.native().parse_unit(buf, False)
    codes, ambig, lengths = c._encode_span(buf, offs)
    want = classify_step(jc._db_planes, jc._taxid_table, jc._tin, jc._tout, jc._parent, jc._root_dense,
                         codes, ambig, lengths, jc._cfg_packed)
    got = c._span_step(codes, ambig, lengths)
    assert tuple(got) == EXACT_OUTPUTS
    for key in EXACT_OUTPUTS:
        w = np.asarray(want[key])
        g = got[key].numpy()
        np.testing.assert_array_equal(g.view(w.dtype) if w.dtype.kind == "u" else g, w, err_msg=key)


# --------------------------------------------- the JAX package's exact tests


@pytest.mark.parametrize("max_runs", [8, 2], ids=["R8", "R2-overflow-rows"])
def test_exact_mode_native_path(max_runs, monkeypatch):
    """tests/test_cli_features.py::test_exact_mode_native_path: on the span
    route the kraken lines are the golden's, and the report's read, call
    and taxon columns too (the k-mer column within the JAX test's margin);
    with two run slots a read, most reads' lines come from the exact step's
    taxids plane (overflow rows)."""
    monkeypatch.setattr(pipeline, "MAX_RUNS", max_runs)
    out, rep, c = _both(exact=True)
    assert c.route == "span" and c.n_spans > 0 and c.n_units == 0
    assert out == _golden("kraken.out")
    got = [l for l in rep.splitlines() if not l.startswith("#")]
    want = [l for l in _golden("report.tsv").splitlines() if not l.startswith("#")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gc, wc = g.split("\t"), w.split("\t")
        assert gc[1:3] == wc[1:3] and gc[6:] == wc[6:], (g, w)
        if gc[3] != "kmers":
            assert abs(int(gc[3]) - int(wc[3])) <= max(2, 0.001 * int(wc[3])), (g, w)


@pytest.mark.parametrize("route", ["span", "python"])
def test_device_counters_exact_mode(route):
    """tests/test_device_counters.py::test_device_counters_exact_mode: the
    counters on the device (counts only), the distinct sets on the host;
    output and report byte-equal to the plain --exact run, on both routes."""
    native = route == "span"
    out0, rep0, _ = _both(exact=True, use_native=native)
    out1, rep1, c = _both(exact=True, use_native=native, device_counters=True)
    dc = c.dev_counters
    assert dc is not None and dc.counts_only and dc.tracker is None and c.route == route
    assert int(dc.kmer_counts.sum()) > 0 and int(dc.read_counts.sum()) > 0
    assert (out1, rep1) == (out0, rep0)


@pytest.mark.parametrize("dc", [False, True], ids=["host", "device-counters"])
@pytest.mark.parametrize("route", ["span", "python"])
def test_ooc_matches_resident_exact(route, dc):
    """The "exact" case of tests/test_outofcore.py::test_ooc_matches_resident
    on both routes, with and without device counters: out of core equals
    resident, both equal to the JAX package's."""
    kw = dict(exact=True, use_native=route == "span", device_counters=dc)
    out0, rep0, c0 = _both(**kw)
    out1, rep1, c1 = _both(preload_size=_tiny_budget(), **kw)
    assert c0._ooc is None and c1._ooc is not None and c1.ooc_groups >= 1
    assert (out1, rep1) == (out0, rep0)


def test_exact_hierarchical():
    """--exact over the hierarchical db_bact + db_viral pair, both routes."""
    dbs = (os.path.join(DATA, "db_bact"), os.path.join(DATA, "db_viral"))
    outs = [_both(dbs=dbs, exact=True, use_native=native)[:2] for native in (True, False)]
    assert outs[0] == outs[1]
    assert outs[0][0] == _golden("kraken_hier.out")


# ----------------------------------------------------- the other options


OPTION_CASES = {
    "print_sequence": {"print_sequence": True},
    "print_sequence-quick": {"print_sequence": True, "quick": True, "min_hits": 2},
    "full_report": {"full_report": True},
    "report_zeros": {"report_zeros": True, "full_report": True},
    "true_hll_precision-14": {"true_hll_precision": True, "hll_precision": 14},
    "true_hll_precision-14-counters": {"true_hll_precision": True, "hll_precision": 14, "device_counters": True},
    "true_hll_precision-14-python": {"true_hll_precision": True, "hll_precision": 14, "use_native": False},
    "hll_precision-0": {"hll_precision": 0, "full_report": True},
    "min_batch_reads": {"min_batch_reads": 8, "use_native": False},
}


@pytest.fixture(scope="module")
def few_reads(tmp_path_factory):
    """The first four golden reads: most taxa get no read (report_zeros)."""
    path = tmp_path_factory.mktemp("few") / "few.fa"
    path.write_text("\n".join(open(READS).read().splitlines()[:8]) + "\n")
    return str(path)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_match_jax(case, few_reads):
    """--print-sequence (the Python route's lines end with the sequence),
    --full-report, report_zeros (on four reads), true_hll_precision
    (precision 14 counters on both routes and on the card's counters),
    hll_precision 0 and min_batch_reads: byte-equal to the JAX package's."""
    opts = OPTION_CASES[case]
    reads = few_reads if "report_zeros" in opts else READS
    out, rep, c = _both(reads, **opts)
    if opts.get("print_sequence"):
        assert c.route == "python"
        assert all(len(line.split("\t")) == 6 for line in out.splitlines())
    if opts.get("true_hll_precision"):
        assert c._cfg.hll_p == c.counter.hll_precision == 14
        assert c.dev_counters is None or c.dev_counters.p == 14
    if "report_zeros" in opts:
        assert rep.count("\n") > _both(reads, full_report=True)[1].count("\n")


def test_true_hll_precision_changes_the_estimates():
    """Precision 14 is taken: its report differs from the default run's in
    the k-mer column only (and agrees with the JAX package's, via _both)."""
    _, rep12, _ = _both()
    _, rep14, _ = _both(true_hll_precision=True, hll_precision=14)
    r12, r14 = [l.split("\t") for l in rep12.splitlines()], [l.split("\t") for l in rep14.splitlines()]
    assert len(r12) == len(r14)
    assert all(a[:3] == b[:3] and a[4:] == b[4:] for a, b in zip(r12, r14))


@pytest.mark.parametrize("flags", [["--exact"], ["--print-sequence"], ["--full-report"],
                                   ["--exact", "--device-counters", "--full-report"],
                                   ["--exact", "--print-sequence", "--preload-size", "40K"]],
                         ids=lambda f: "".join(f))
def test_cli_flags_match_jax(flags, tmp_path):
    """The CLI's --exact, --print-sequence and --full-report, alone and
    together with --device-counters and --preload-size: kraken output and
    report body byte-equal to the JAX package's CLI (the two-line
    provenance header names each package)."""
    results = []
    for name, main, extra in (("port", cli_main, ["--device", "cpu"]), ("jax", jax_cli_main, [])):
        out, rep = tmp_path / f"{name}.out", tmp_path / f"{name}.tsv"
        rc = main(["--db", DATA, *extra, *flags, "--output", str(out), "--report-file", str(rep), READS])
        assert rc == 0
        lines = rep.read_text().splitlines(keepends=True)
        assert lines[0].startswith("# KrakenUniq-TPU") and lines[1].startswith("# CL:")
        results.append((out.read_text(), "".join(lines[2:])))
    assert results[0] == results[1]
