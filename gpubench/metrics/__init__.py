"""One reader a metric, `<name>.py` with `read(ctx)`, found by the metric's
name in BENCHMARK.json; `_bounds.py` and `_trace.py` hold what they share.
A reader that finds nothing to read returns None."""


def roofline_pct(trace: dict | None, names) -> float | None:
    """100 x the kernels' summed bounds over their summed card time, over
    the launches the profiler recorded (each launch's bound taken as the
    mean of the kernel's launches in the window)."""
    if trace is None:
        return None
    bound = device = 0.0
    for name in names:
        rec, n = trace["kernels"][name]["records"], trace["launches"][name]
        if rec and n:
            bound += trace["bounds_s"][name] / n * rec
            device += trace["kernels"][name]["device_s"]
    return 100.0 * bound / device if device > 0 else None


def per_span(ctx: dict, seconds: float) -> float | None:
    """Milliseconds a span over the window's samples."""
    n = ctx["counters"]["n_spans"]
    return 1e3 * seconds / n if n else None
