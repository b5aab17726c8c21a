"""host_offcpu_ms.odom: milliseconds the calling thread spent off the CPU
inside the program's odometry.step spans (wall minus thread CPU time), a step."""

from perfbench.spans import offcpu_ms_per_unit


def read(ctx):
    return offcpu_ms_per_unit(ctx, "odometry.step")
