"""The report's hot spot as a work count, millions a sample: the
"union_entries" count of the "report.aggregate" spans (both sparse sets'
sizes fed to each np.union1d of HLL.merge) under the window's "report"
roots."""

from gpubench.metrics import _spans


def read(ctx):
    v = _spans.per_sample(ctx, "report.aggregate", count="union_entries")
    return None if v is None else v / 1e6
