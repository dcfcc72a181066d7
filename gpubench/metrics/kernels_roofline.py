"""The port's kernels on the path together: 100 x their summed bounds
over their summed card time in the traced window (metrics/_bounds.py)."""

from gpubench.metrics import roofline_pct
from gpubench.metrics._trace import SYMBOLS


def read(ctx):
    return roofline_pct(ctx["trace"], SYMBOLS)
