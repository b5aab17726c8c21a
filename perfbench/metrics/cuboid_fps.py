"""cuboid_fps: frames whose CuboidResult reached the host in the window, a second."""

from perfbench.readers import rate


def read(ctx):
    return rate(ctx)
