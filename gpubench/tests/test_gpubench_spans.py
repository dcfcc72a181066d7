"""The readers of the program's own spans (metrics/_spans.py): on a CPU run
of a toy cell each reads a number from the recorder's spans; on spans made
by hand each reads what its metric says; without the recorder (an older
program) or its spans each reads None."""

import types

import pytest

from conftest import run_toy

READERS = ("report_aggregate_s", "report_write_s", "report_union_m_entries", "parse_ms_per_span",
           "fetch_wait_ms_per_span", "run_other_ms_per_span", "taxonomy_parse_s")


@pytest.mark.parametrize("workload", ["refseq-k31.illumina150", "refseq-k31-ooc8.illumina150"])
def test_traced_run_reads_the_spans(bench, data_dir, workload):
    out = run_toy(bench, workload, data_dir, 2147483723, trace=True)
    assert out["correct"]
    got = {name: out["metrics"][name]["value"] for name in READERS}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    # the CPU route has no fetch to wait on; everything else took time
    assert got["fetch_wait_ms_per_span"] == 0 and all(v > 0 for k, v in got.items() if k != "fetch_wait_ms_per_span")


def _ctx(spans, samples=2, n_spans=4):
    classifier = types.SimpleNamespace(spans=lambda: spans)
    return {"classifier": classifier, "window": {"samples": samples}, "counters": {"n_spans": n_spans}}


def _made(monkeypatch):
    """Set-up, a warm-up sample and two window samples, spans made by hand
    on a fresh recorder with set durations."""
    from krakenuniq_tpu_torch.utils import trace

    rec = trace.Recorder()
    monkeypatch.setattr(trace, "_RECORDER", rec)
    clock = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(clock))
    with trace.span("load"):
        with trace.span("load.taxonomy"):
            pass
    for _ in range(3):
        with trace.span("run", run=trace.new_run()):
            for i in range(2):
                with trace.span("parse"):
                    pass
                with trace.span("span.fold", span=i):
                    pass
                with trace.span("span.fetch_wait", span=i):
                    pass
        with trace.span("report", run=trace.new_run()):
            with trace.span("report.aggregate"):
                trace.count("union_entries", 3_000_000)
            with trace.span("report.write"):
                pass
    return trace.spans()


def test_readers_on_spans_made_by_hand(bench, monkeypatch):
    ctx = _ctx(_made(monkeypatch))
    got = {name: bench.reader(name)(ctx) for name in READERS}
    # the clock steps 1 us a reading: a leaf lasts 1 us, a run root 13 us of
    # which 6 x 1 us are its children's
    assert got == pytest.approx({"report_aggregate_s": 1e-6, "report_write_s": 1e-6, "report_union_m_entries": 3.0,
                                 "parse_ms_per_span": 2 * 2e-3 / 4, "fetch_wait_ms_per_span": 2 * 2e-3 / 4,
                                 "run_other_ms_per_span": 2 * 7e-3 / 4, "taxonomy_parse_s": 1e-6})


@pytest.mark.parametrize("classifier", ["no recorder", "no spans"])
def test_readers_without_spans_read_none(bench, classifier):
    ctx = _ctx([])
    if classifier == "no recorder":
        ctx["classifier"] = types.SimpleNamespace()
    for name in READERS:
        assert bench.reader(name)(ctx) is None, name
