"""host_ms.cuboid.icp: host milliseconds inside the program's
cuboid.estimate_cuboid_pose spans in the traced window, a frame."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "cuboid.estimate_cuboid_pose")
