"""The span route's host milliseconds a span (Classifier.host_seconds /
n_spans, summed over the window's samples)."""

from gpubench.metrics import per_span


def read(ctx):
    return per_span(ctx, ctx["counters"]["host_seconds"])
