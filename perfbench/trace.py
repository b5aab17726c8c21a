"""Reading a torch.profiler trace of the window: device intervals, their
union, time by kernel name, and the idle gaps between them.

Every time here is in seconds on the host's ``perf_counter`` clock. The
profiler's own clock is mapped onto it by one marker: on an idle device the harness
reads ``perf_counter`` and at once launches a fill kernel, the trace's
first device operation, which starts some microseconds later.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Sequence, Tuple

_IDENT = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:<[^()]*>)?\s*\(")


class DeviceOp(NamedTuple):
    name: str
    start: float
    end: float


def kineto_ops(prof, marker_host_s: float) -> List[DeviceOp]:
    """The device operations (kernels, copies, sets) of a finished
    ``torch.profiler`` run with CUDA activity, on the host clock, sorted
    by start. Read from the kineto results, without building the host
    event tree."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()]
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    offset = marker_host_s - min(e.start_ns() for e in dev) / 1e9
    ops = [DeviceOp(e.name(), e.start_ns() / 1e9 + offset, e.end_ns() / 1e9 + offset) for e in dev]
    ops.sort(key=lambda o: o.start)
    return ops


def kernel_name(name: str) -> str:
    """A device operation's function name without namespace, template
    arguments or parameters: "(anonymous namespace)::icp_gn_nn_kernel(float
    const*, ...)" -> "icp_gn_nn_kernel"; a copy, a set or a name without
    parameters as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    m = None
    for m in _IDENT.finditer(name):
        if m.group(1) != "namespace":
            break
    return m.group(1) if m and m.group(1) != "namespace" else name


def clip(ops: Sequence[DeviceOp], start: float, end: float) -> List[DeviceOp]:
    """The operations that start inside [start, end), cut to end there."""
    return [DeviceOp(o.name, o.start, min(o.end, end)) for o in ops if start <= o.start < end]


def union_s(ops: Sequence[DeviceOp]) -> float:
    """Seconds in which at least one operation ran (ops sorted by start)."""
    total, cur_s, cur_e = 0.0, None, None
    for o in ops:
        if cur_e is None or o.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = o.start, o.end
        else:
            cur_e = max(cur_e, o.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(ops: Sequence[DeviceOp], start: float, end: float) -> List[Tuple[float, float, str]]:
    """The idle intervals of [start, end) between the operations (sorted
    by start): (gap start, gap end, name of the operation before it)."""
    out, t, last = [], start, "window start"
    for o in ops:
        if o.start > t:
            out.append((t, o.start, last))
        if o.end > t:
            t, last = o.end, o.name
    if end > t:
        out.append((t, end, last))
    return out


def seconds_by_name(ops: Sequence[DeviceOp]) -> dict:
    """{name: (summed seconds, count)}."""
    out = {}
    for o in ops:
        s, n = out.get(o.name, (0.0, 0))
        out[o.name] = (s + (o.end - o.start), n + 1)
    return out


def phase_at(spans: Sequence[Tuple[float, float, str]], t: float) -> str:
    """The name of the host span (start, end, name) holding time t."""
    for s, e, name in spans:
        if s <= t < e:
            return name
    return "harness"
