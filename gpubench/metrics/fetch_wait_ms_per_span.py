"""The host's wait on each span's fetch, milliseconds a span: the
"span.fetch_wait" spans (the wait on the fetch stream's end event) under
the window's "run" roots, over the window's spans (0 where no fetch was
waited on: the CPU)."""

from gpubench.metrics import _spans, per_span


def read(ctx):
    s = _spans.seconds(ctx, "run", "span.fetch_wait")
    return None if s is None else per_span(ctx, s)
