"""k1_roofline_pct: K1's least time at the cell's shape over its mean device
time a launch, in percent."""

from perfbench.counts import k1
from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, k1, "k1")
