"""The card's busy milliseconds a span with the tables resident: the union
of the profiler's card records in the traced window over the spans."""

from gpubench.metrics import per_span


def read(ctx):
    t = ctx["trace"]
    if t is None or ctx["counters"]["ooc_groups"]:
        return None
    return per_span(ctx, t["busy_s"])
