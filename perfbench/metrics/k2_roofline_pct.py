"""k2_roofline_pct: K2's least time at the cell's shape over the mean device
time of a launch (its three kernels summed), in percent."""

from perfbench.counts import k2
from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, k2, "k2")
