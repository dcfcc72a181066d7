"""Seconds of Classifier.write_report over one sample's counts, the mean
over the window's samples (host clock)."""


def read(ctx):
    r = ctx["window"]["report_s"]
    return sum(r) / len(r)
