"""The port's span recorder: one a process, always on.

A span is the host's interval at one layer boundary (set-up, the span
route, the report): its name, an id, its parent's id, its start and end on
`time.perf_counter_ns()`, its ids and its counts. Module functions open
spans with `span(name, **ids)` and need no handle:

    with trace.span("span.fold", span=idx) as sp:
        ...
    sp.seconds, sp.self_seconds

A span takes its parent's ids, then its own: the run's number (`run`, one
`Classifier.run` or one `write_report`), the global span index (`span`), the
out-of-core group (`group`) and the database (`db`). `count(name, n)` adds
to the innermost open span's counts. Finished spans go to a bounded log
(LOG_SPANS, the oldest dropped and counted in `dropped()`) that `spans()`
reads; nothing is written to disk and no counter reset clears it.

While a torch profiler records (torch's own flag, read once a span), a span
also enters `torch.profiler.record_function("kuniq.<name>")`, so that it
lies on the clock of the card's kernels and copies in the profiler's trace.

Spans sit at layer boundaries only, never one a read, a taxon or a report
row: a span costs a few microseconds. One thread opens and closes the
spans of a process (the port's host route is single-threaded); a thread
that opens spans gets a stack of its own.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

LOG_SPANS = 65536  # finished spans kept
PREFIX = "kuniq."  # the profiler ranges' names


class Span:
    """One span: open inside its `with`, then a record in the log. `ids`
    and `counts` are dicts; `child_ns` the walls of its direct children
    by name."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "ids", "counts", "child_ns", "_range")

    def __init__(self, name: str, ids: dict):
        self.name = name
        self.ids = ids
        self.counts: dict = {}
        self.child_ns: dict = {}
        self.id = self.parent = self.start_ns = self.end_ns = None
        self._range = None

    def __enter__(self) -> "Span":
        _RECORDER.open(self)
        return self

    def __exit__(self, *exc) -> None:
        _RECORDER.close(self)

    @property
    def seconds(self) -> float:
        """The span's wall."""
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_seconds(self) -> float:
        """The wall its child spans do not cover."""
        return (self.end_ns - self.start_ns - sum(self.child_ns.values())) / 1e9

    def child_seconds(self, name: str) -> float:
        """The summed wall of its direct children called `name`."""
        return self.child_ns.get(name, 0) / 1e9

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.id}, parent={self.parent}, ids={self.ids}, counts={self.counts})"


class Recorder:
    def __init__(self, capacity: int = LOG_SPANS):
        self._log: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._ids = 0
        self._runs = 0
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, sp: Span) -> None:
        stack = self._stack()
        if stack:
            top = stack[-1]
            sp.parent = top.id
            sp.ids = {**top.ids, **sp.ids}
        self._ids += 1
        sp.id = self._ids
        stack.append(sp)
        if torch._C._autograd._profiler_enabled():
            sp._range = torch.profiler.record_function(PREFIX + sp.name)
            sp._range.__enter__()
        sp.start_ns = time.perf_counter_ns()

    def close(self, sp: Span) -> None:
        sp.end_ns = time.perf_counter_ns()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        stack = self._stack()
        stack.pop()  # sp: `with` blocks nest
        if stack:
            kids = stack[-1].child_ns
            kids[sp.name] = kids.get(sp.name, 0) + sp.end_ns - sp.start_ns
        if len(self._log) == self._log.maxlen:
            self._dropped += 1
        self._log.append(sp)

    def count(self, name: str, n: int) -> None:
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def new_run(self) -> int:
        self._runs += 1
        return self._runs


_RECORDER = Recorder()


def span(name: str, **ids) -> Span:
    """A span named `name` (open it with `with`); `ids` join its parent's."""
    return Span(name, ids)


def count(name: str, n: int) -> None:
    """Add n to the innermost open span's count `name` (none open: dropped)."""
    _RECORDER.count(name, n)


def new_run() -> int:
    """The next run number of the process (a `run` or `report` root's id)."""
    return _RECORDER.new_run()


def spans() -> list[Span]:
    """The finished spans in the log, oldest first (a child before its
    parent)."""
    return list(_RECORDER._log)


def dropped() -> int:
    """Spans the log has dropped, oldest first, since the process began."""
    return _RECORDER._dropped
