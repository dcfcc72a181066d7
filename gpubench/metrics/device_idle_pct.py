"""Share of the traced window with no kernel, copy or set on the card
(the union of the profiler's card records)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
