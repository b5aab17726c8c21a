"""Shared arithmetic of the metric readers in ``perfbench/metrics/``."""

from __future__ import annotations

import statistics

from perfbench import trace
from perfbench.counts import peaks


def rate(ctx) -> float:
    """Units whose result reached the host in the window, a second."""
    return ctx.window.units / ctx.window.seconds


def percentile_ms(ctx, q: int):
    lat = ctx.window.latencies
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1] * 1e3


def entry_ms_per_unit(ctx):
    return ctx.window.entry_s / ctx.window.units * 1e3


def launches_per_unit(ctx):
    if ctx.ops is None:
        return None
    return len(ctx.ops) / ctx.window.units


def idle_pct(ctx):
    if ctx.ops is None:
        return None
    return 100.0 * (1.0 - trace.union_s(ctx.ops) / ctx.window.seconds)


def roofline_pct(ctx, counts, key: str):
    """100 x the least time of one launch (``counts.ops`` and
    ``counts.nbytes`` at the cell's shape, against the f32 and HBM peaks)
    over its mean device time, its kernels' times summed by name."""
    if ctx.ops is None or key not in ctx.kernel_shapes:
        return None
    mine = [o for o in ctx.ops if trace.kernel_name(o.name) in counts.KERNELS]
    launch = getattr(counts, "LAUNCH_KERNEL", counts.KERNELS[0])
    launches = sum(trace.kernel_name(o.name) == launch for o in mine)
    if not launches:
        return None
    device_s = sum(o.end - o.start for o in mine) / launches
    shape = ctx.kernel_shapes[key]
    least, _ = peaks.bound_s(counts.ops(*shape), counts.nbytes(*shape))
    return 100.0 * least / device_s
