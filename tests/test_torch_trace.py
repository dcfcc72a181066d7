"""The port's span recorder (krakenuniq_tpu_torch/utils/trace.py) on the CPU,
over copies of the golden database: the spans of set-up, the span route
(resident, out of core), the Python route and the report nest under their
roots with their ids; the counters and `.timings` the benchmark reads are
sums of those spans; the report's `union_entries` counts what HLL.merge
unites; spans enter torch.profiler ranges only while a profiler records;
the log is bounded."""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from krakenuniq_tpu_torch.classify import Classifier, ClassifyOptions, pipeline
from krakenuniq_tpu_torch.db import hash_table
from krakenuniq_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")
# small work units and spans: a run of the golden reads takes several spans
SMALL = {"WORK_UNIT_SIZE": 1500, "SPAN_READS": 40}
ROUTES = {"resident": {}, "out-of-core": {"preload_size": 64 << 10}, "python": {"use_native": False}}
STAGES = ("encode", "step", "probe", "uid", "counters", "fold", "format")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test alone."""
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "_RECORDER", rec)
    return rec


def _db(tmp_path) -> str:
    """A copy of the golden database without any table cache."""
    dst = tmp_path / "db"
    os.makedirs(dst, exist_ok=True)
    for name in ("database.kdb", "database.idx", "taxDB", "database.kdb.counts"):
        shutil.copy(os.path.join(DATA, name), dst / name)
    return str(dst)


def _classify(db: str, monkeypatch, route: str) -> Classifier:
    """Load, run the golden reads and write their report."""
    for name, value in SMALL.items():
        monkeypatch.setattr(pipeline, name, value)
    c = Classifier([db], ClassifyOptions(device="cpu", print_progress=False, **ROUTES[route]))
    c.run([os.path.join(DATA, "reads.fa")], kraken_fh=io.StringIO())
    c.write_report(io.StringIO())
    return c


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _wall(spans, name):
    return sum(s.seconds for s in _named(spans, name))


@pytest.mark.parametrize("route", ["resident", "out-of-core"])
def test_spans_nest_under_their_roots(route, recorder, tmp_path, monkeypatch):
    c = _classify(_db(tmp_path), monkeypatch, route)
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    want = {"load", "load.taxonomy", "load.tables", "load.tables.read", "load.tables.build", "run", "parse",
            "span.encode", "span.step", "span.fold", "span.format", "report", "report.aggregate", "report.write"}
    want |= {"ooc.group", "load.tables.pin"} if route == "out-of-core" else {"span.step.cpu", "load.tables.upload"}
    assert want <= names
    assert {s.name for s in spans if s.parent is None} == {"load", "run", "report"}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
            assert {k: v for k, v in s.ids.items() if k in p.ids} == p.ids  # a child carries its parent's ids
    for s in spans:  # each span's child walls, by name, are its children's
        kids = [k for k in spans if k.parent == s.id]
        assert s.child_ns == {n: sum(k.end_ns - k.start_ns for k in _named(kids, n)) for n in {k.name for k in kids}}
    (run,), (report,) = _named(spans, "run"), _named(spans, "report")
    assert run.ids["run"] != report.ids["run"]
    under_run = [s for s in spans if s.ids.get("run") == run.ids["run"] and s is not run]
    assert {"parse", "span.encode", "span.fold", "span.format"} <= {s.name for s in under_run}
    assert c.n_spans >= 3
    for stage in ("span.encode", "span.fold", "span.format"):
        assert sorted(s.ids["span"] for s in _named(spans, stage)) == list(range(c.n_spans))
    # out of core a span's step stage also puts its feed on the card
    assert {s.ids["span"] for s in _named(spans, "span.step")} == set(range(c.n_spans))
    assert [s.ids["db"] for s in _named(spans, "load.tables")] == [0]
    if route == "out-of-core":
        assert sorted(s.ids["group"] for s in _named(spans, "ooc.group")) == list(range(c.ooc_groups))
    assert trace.dropped() == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_counters_and_timings_are_sums_of_spans(route, recorder, tmp_path, monkeypatch):
    db = _db(tmp_path)
    for load in ("cold", "warm"):  # a table built and cached, then read from the cache
        recorder._log.clear()
        c = _classify(db, monkeypatch, route)
        spans = trace.spans()
        if route == "python":
            assert c.n_units > 0 and c.n_spans == 0
            assert c.device_seconds == pytest.approx(_wall(spans, "unit.step"), rel=1e-9)
            assert c.host_seconds == pytest.approx(_wall(spans, "unit") - _wall(spans, "unit.step"), rel=1e-9)
        else:
            for stage in STAGES:
                name = "ooc.group" if stage == "probe" else "span." + stage
                got = sum(s.self_seconds for s in _named(spans, name))
                assert c.span_host_seconds[stage] == pytest.approx(got, rel=1e-9, abs=1e-12), stage
            assert c.host_seconds == pytest.approx(sum(c.span_host_seconds.values()), rel=1e-9)
            assert c.device_seconds == pytest.approx(_wall(spans, "span.step.cpu"), rel=1e-9)
        t = c.dbs[0].timings if c._ooc is None else c._ooc[0].timings
        assert t["cache"] == ("miss" if load == "cold" else "hit")
        assert t["read"] == _wall(spans, "load.tables.read")
        if load == "warm":
            assert t["cache_read"] == _wall(spans, "load.tables.cache_read") and "build" not in t
        elif c._ooc is None:
            assert t["build"] == _wall(spans, "load.tables.build")
            assert t["cache_write"] == _wall(spans, "load.tables.cache_write")
            for step in ("hash", "place", "planes", "check"):
                assert t["build_" + step] == pytest.approx(_wall(spans, "hash_table." + step), rel=1e-9)
        else:
            assert t["build"] == pytest.approx(_wall(spans, "load.tables.cache_read") + _wall(
                spans, "load.tables.build") - t["pin"], rel=1e-9)
        if c._ooc is None:
            assert t["upload"] == _wall(spans, "load.tables.upload")
        else:
            assert t["pin"] == pytest.approx(_wall(spans, "load.tables.pin"), rel=1e-9)


def test_union_entries_count_what_merge_unites(recorder, tmp_path, monkeypatch):
    c = _classify(_db(tmp_path), monkeypatch, "resident")
    fed = []
    union1d = np.union1d

    def counted(a, b, *args, **kw):
        fed.append(len(a) + len(b))
        return union1d(a, b, *args, **kw)

    monkeypatch.setattr(np, "union1d", counted)
    c.write_report(io.StringIO())
    (agg,) = [s for s in _named(trace.spans(), "report.aggregate") if s.ids["run"] == trace._RECORDER._runs]
    assert len(fed) > 1 and agg.counts["union_entries"] == sum(fed)


def test_profiler_ranges_mirror_the_spans(recorder, tmp_path, monkeypatch):
    db = _db(tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = _classify(db, monkeypatch, "resident")
    names = [e.name for e in prof.events()]
    assert {"kuniq.load", "kuniq.run", "kuniq.span.fold", "kuniq.report.aggregate"} <= set(names)
    assert names.count("kuniq.span.fold") == c.n_spans
    assert len([n for n in names if n.startswith(trace.PREFIX)]) == len(trace.spans())


def test_no_profiler_no_range(recorder, tmp_path, monkeypatch):
    entered = []

    class Counted(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    db = _db(tmp_path)
    _classify(db, monkeypatch, "resident")
    assert entered == [] and trace.spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert entered == ["kuniq.probe"]


def test_bounded_log_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDER", trace.Recorder(capacity=4))
    for i in range(10):
        with trace.span(f"s{i}", span=i):
            trace.count("n", i)
    assert [s.name for s in trace.spans()] == ["s6", "s7", "s8", "s9"]
    assert [s.counts for s in trace.spans()] == [{"n": i} for i in range(6, 10)]
    assert trace.dropped() == 6


def test_counts_go_to_the_innermost_span(recorder):
    trace.count("lost", 1)  # no span open
    with trace.span("outer", run=7) as outer:
        trace.count("a", 2)
        with trace.span("inner", span=3) as inner:
            trace.count("a", 5)
            trace.count("a", 1)
        trace.count("b", 1)
    assert outer.counts == {"a": 2, "b": 1} and inner.counts == {"a": 6}
    assert inner.ids == {"run": 7, "span": 3} and inner.parent == outer.id and outer.parent is None
    assert outer.child_seconds("inner") == inner.seconds
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds, abs=1e-9)


def test_span_closes_on_raise(recorder):
    with pytest.raises(KeyError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise KeyError("x")
    with trace.span("after") as after:
        pass
    assert [s.name for s in trace.spans()] == ["inner", "outer", "after"] and after.parent is None


def test_report_stats_reads_the_run_span(recorder, tmp_path, monkeypatch):
    c = _classify(_db(tmp_path), monkeypatch, "resident")
    (run,) = _named(trace.spans(), "run")
    out = io.StringIO()
    c.report_stats(out)
    assert c._elapsed == run.seconds > 0
    line = out.getvalue().split("\n")[0]
    assert line == "\r%d sequences (%.2f Mbp) processed in %.3fs (%.1f Kseq/m, %.2f Mbp/m)." % (
        c.total_sequences, c.total_bases / 1e6, run.seconds, c.total_sequences / 1e3 / (run.seconds / 60),
        c.total_bases / 1e6 / (run.seconds / 60))


@pytest.mark.parametrize("layout", ["auto", "chd-failed"])
def test_hash_table_timings_are_its_spans(layout, recorder, monkeypatch):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    values = rng.integers(1, 200, len(keys)).astype(np.uint32)
    timings = {}
    if layout == "chd-failed":
        monkeypatch.setattr(hash_table, "_chd_place", lambda *a, **kw: None)
        with pytest.raises(hash_table.HashBuildError):
            hash_table.build_hash_table(keys, values, timings=timings, layout="chd", force_lr=14)
    else:
        hash_table.build_hash_table(keys, values, timings=timings)
    (root,) = _named(trace.spans(), "hash_table")
    assert set(timings) == {"hash", "place", "planes", "check"}
    for step, s in timings.items():
        assert s == root.child_seconds("hash_table." + step) == pytest.approx(_wall(trace.spans(),
                                                                                  "hash_table." + step))
    assert (timings["planes"] > 0) == (layout == "auto")
