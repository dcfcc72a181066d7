"""chd_probe alone: 100 x its bounds over its card time in the traced window."""

from gpubench.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx["trace"], ["chd_probe"])
