"""The report's clade aggregation, seconds a sample: the "report.aggregate"
spans (TaxReport._aggregate: each taxon's counts fanned out to its
ancestors and merged per clade) under the window's "report" roots."""

from gpubench.metrics import _spans


def read(ctx):
    return _spans.per_sample(ctx, "report.aggregate")
