"""The program's own spans (krakenuniq_tpu_torch/utils/trace.py), read
through `Classifier.spans()`: the window's are the last `samples` "run"
and "report" roots and the spans under them (a span carries its root's
"run" id); set-up's are the last "load" root's. A program without the
recorder gives None, and so does every reader built on it."""


def _log(ctx: dict) -> list | None:
    spans = getattr(ctx["classifier"], "spans", None)
    return spans() if callable(spans) else None


def window(ctx: dict, root: str) -> tuple[list, list] | None:
    """The window's `root` spans ("run" or "report") and their
    descendants, or None."""
    log = _log(ctx)
    n = ctx["window"]["samples"]
    if log is None or not n:
        return None
    roots = [s for s in log if s.name == root and s.parent is None][-n:]
    if len(roots) < n:
        return None
    runs = {s.ids["run"] for s in roots}
    return roots, [s for s in log if s.parent is not None and s.ids.get("run") in runs]


def seconds(ctx: dict, root: str, name: str) -> float | None:
    """The summed wall of the window's `name` spans under its `root`
    spans (0 when none ran), or None without the window's roots."""
    w = window(ctx, root)
    return None if w is None else sum(s.seconds for s in w[1] if s.name == name)


def per_sample(ctx: dict, name: str, count: str | None = None) -> float | None:
    """A report span's seconds (or its count `count`) over the window's
    samples, or None where the window's reports have no such span."""
    w = window(ctx, "report")
    found = [] if w is None else [s for s in w[1] if s.name == name]
    if not found:
        return None
    total = sum(s.counts.get(count, 0) for s in found) if count else sum(s.seconds for s in found)
    return total / len(w[0])


def setup_child(ctx: dict, name: str) -> float | None:
    """The summed wall of set-up's `name` spans directly under its last
    "load" root, or None where it has none."""
    log = _log(ctx)
    loads = [s for s in log or () if s.name == "load" and s.parent is None]
    if not loads:
        return None
    found = [s for s in log if s.name == name and s.parent == loads[-1].id]
    return sum(s.seconds for s in found) if found else None
