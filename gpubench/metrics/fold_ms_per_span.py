"""The host's HLL fold, milliseconds a span (span_host_seconds["fold"],
summed over the window's samples)."""

from gpubench.metrics import per_span


def read(ctx):
    return per_span(ctx, ctx["counters"]["span_host_seconds"]["fold"])
