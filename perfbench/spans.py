"""The program's own spans inside its entries, read for per-layer metrics.

The program (``perception_tpu_torch.utils.profiler.span``) records a span
only while a ``torch.profiler`` is active, which in a run of the harness
is the traced window alone. Each span is stamped with
``time.perf_counter``, the harness's clock, onto which ``perfbench/trace.py``
maps the device trace, so a span's interval and ``ctx.ops`` compare
directly. Where the window holds none of the spans a reader wants (a
program without spans, an untraced run) it gives None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple


def window_spans(ctx) -> list:
    """The program's spans that began inside the window (none from a
    program without spans)."""
    try:
        from perception_tpu_torch.utils.profiler import spans
    except ImportError:  # a program without spans
        return []
    return [s for s in spans() if ctx.window.start <= s.t0 < ctx.window.end]


def named(records, name: str, parent: Optional[str] = None) -> list:
    """The spans called ``name`` (whose parent is called ``parent``, if given)."""
    if parent is not None:
        names = {s.id: s.name for s in records}
        return [s for s in records if s.name == name and names.get(s.parent) == parent]
    return [s for s in records if s.name == name]


def host_ms_per_unit(ctx, name: str, parent: Optional[str] = None):
    """Summed host milliseconds inside the window's ``name`` spans, a unit of work."""
    found = named(window_spans(ctx), name, parent)
    if not found:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in found) / ctx.window.units


def offcpu_ms_per_unit(ctx, name: str):
    """Milliseconds the thread spent off the CPU inside the window's
    ``name`` spans (wall minus the thread's CPU time), a unit of work."""
    found = named(window_spans(ctx), name)
    if not found:
        return None
    return 1e3 * sum(s.t1 - s.t0 - s.cpu_s for s in found) / ctx.window.units


def merged(ops) -> List[Tuple[float, float]]:
    """The union of the operations' intervals (sorted by start) as
    disjoint (start, end) pairs in order."""
    out: List[List[float]] = []
    for o in ops:
        if out and o.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.start, o.end])
    return [(a, b) for a, b in out]


def busy_in(union: Sequence[Tuple[float, float]], starts: Sequence[float], a: float, b: float) -> float:
    """Seconds of [a, b) covered by the disjoint intervals ``union``
    (``starts`` their starts)."""
    total = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(union) and union[i][0] < b:
        lo, hi = max(union[i][0], a), min(union[i][1], b)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def device_idle_pct_in(ctx, name: str):
    """100 x (1 - device-busy time inside the window's ``name`` spans /
    their summed length): how idle the device was while the host was in
    that stage."""
    if ctx.ops is None:
        return None
    found = named(window_spans(ctx), name)
    length = sum(s.t1 - s.t0 for s in found)
    if not found or length <= 0:
        return None
    union = merged(ctx.ops)
    starts = [a for a, _ in union]
    busy = sum(busy_in(union, starts, s.t0, s.t1) for s in found)
    return 100.0 * (1.0 - busy / length)
