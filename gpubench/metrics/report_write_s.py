"""The report's tree walk, seconds a sample: the "report.write" spans
(TaxReport.write: each printed row's estimate and its formatting) under the
window's "report" roots."""

from gpubench.metrics import _spans


def read(ctx):
    return _spans.per_sample(ctx, "report.write")
