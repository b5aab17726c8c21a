"""host_ms.odom.map_fuse: host milliseconds inside the program's
odometry.map_fuse spans (re-anchor, voxel fuse, hash rebuild on a
promotion) in the traced window, a step."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "odometry.map_fuse")
