"""The span route's input parse, milliseconds a span: the "parse" spans
(a native chunk's read, parse_unit and cut into units and spans) under the
window's "run" roots, over the window's spans."""

from gpubench.metrics import _spans, per_span


def read(ctx):
    s = _spans.seconds(ctx, "run", "parse")
    return None if s is None else per_span(ctx, s)
