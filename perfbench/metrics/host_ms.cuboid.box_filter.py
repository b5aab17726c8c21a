"""host_ms.cuboid.box_filter: host milliseconds inside the program's
cuboid.box_filter spans in the traced window, a frame."""

from perfbench.spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "cuboid.box_filter")
