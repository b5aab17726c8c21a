"""device_idle_pct.odom.track: 100 x (1 - device-busy time inside the
program's odometry.track_keyframe spans / their summed length)."""

from perfbench.spans import device_idle_pct_in


def read(ctx):
    return device_idle_pct_in(ctx, "odometry.track_keyframe")
