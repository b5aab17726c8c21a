"""odom_p95_ms: the 95th percentile over the window's steps of the time from
handing a frame to odometry_step until its pose is on the host."""

from perfbench.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
