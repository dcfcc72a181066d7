"""The span route's wall outside every stage, milliseconds a span: the
window's "run" roots' self time (their wall less the part their child
spans cover: parse, the stages, the fetch waits, the group passes), over
the window's spans."""

from gpubench.metrics import _spans, per_span


def read(ctx):
    w = _spans.window(ctx, "run")
    return None if w is None else per_span(ctx, sum(s.self_seconds for s in w[0]))
