"""device_idle_pct.cuboid.icp: 100 x (1 - device-busy time inside the
program's cuboid.estimate_cuboid_pose spans / their summed length)."""

from perfbench.spans import device_idle_pct_in


def read(ctx):
    return device_idle_pct_in(ctx, "cuboid.estimate_cuboid_pose")
