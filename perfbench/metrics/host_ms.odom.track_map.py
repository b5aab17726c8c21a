"""host_ms.odom.track_map: host milliseconds inside the program's
odometry.track_map spans in the traced window, a step."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "odometry.track_map")
