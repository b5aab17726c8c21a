"""odom_fps: odometry steps whose pose reached the host in the window, a second."""

from perfbench.readers import rate


def read(ctx):
    return rate(ctx)
