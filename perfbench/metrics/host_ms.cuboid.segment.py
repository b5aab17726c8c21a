"""host_ms.cuboid.segment: host milliseconds inside the program's
cuboid.segment_ground_plane spans in the traced window, a frame."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "cuboid.segment_ground_plane")
