"""launches_per_frame.odom: device kernels, copies and sets in the traced
window, a frame."""

from perfbench.readers import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx)
