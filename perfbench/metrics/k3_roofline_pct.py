"""k3_roofline_pct: K3+K4's least time at the cell's mean pairs a launch
over the mean device time of a launch (its scan and merge kernels
summed), in percent."""

from perfbench.counts import k3
from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, k3, "k3")
