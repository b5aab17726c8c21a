"""device_idle_pct.odom: 100 x (1 - union of the device operations'
intervals / the traced window)."""

from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
