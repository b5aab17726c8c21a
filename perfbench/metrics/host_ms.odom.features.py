"""host_ms.odom.features: host milliseconds inside the program's
odometry.frame_features spans under an odometry.step in the traced window, a step."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "odometry.frame_features", parent="odometry.step")
