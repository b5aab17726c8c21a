"""host_offcpu_ms.cuboid: milliseconds the calling thread spent off the CPU
inside the program's cuboid.pipeline spans (wall minus thread CPU time), a frame."""

from perfbench.spans import offcpu_ms_per_unit


def read(ctx):
    return offcpu_ms_per_unit(ctx, "cuboid.pipeline")
