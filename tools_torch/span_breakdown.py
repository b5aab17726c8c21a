"""Per-stage breakdown of one benchmark cell's traced window, from the
program's spans (``perception_tpu_torch.utils.profiler.span``).

Sets the cell up as ``perfbench/run.py`` does, runs its window under the
harness's ``torch.profiler`` (CUDA activity, the same marker onto the host
clock) and prints, for each span name: its count, host ms a unit, the
thread's CPU and off-CPU ms a unit, involuntary context switches, the
device's idle share while the host was inside it and the kernels it
launched; the root spans' host ms a unit against the harness's
``entry_s`` a unit; and every device idle gap of at least ``--gap-ms``,
named by the innermost span holding it, with that span's wall, CPU time
and switches; and the CUDA graphs captured and replayed, in all and
inside the window, which show a graph engaged (``_graph.captures`` and
``.replays`` by the captured function: ``_fused_gn``, keyframe mode's
loop on K2, and ``_hash_solve``, map mode's on K3+K4). ``--json`` writes
the same, and every long unit's stages.

Needs a CUDA card. Run from the repository root:
``python3 tools_torch/span_breakdown.py --workload odom.live_kf32k --seed 7 [--seconds 10] [--json PATH]``
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from perfbench import harness, spans as sp, trace as tr  # noqa: E402
from perfbench.systems.record import Window, now  # noqa: E402
from perception_tpu_torch import _graph  # noqa: E402
from perception_tpu_torch.utils import profiler  # noqa: E402


def track_graphs() -> dict:
    """The graphs' captures and replays so far, by the captured function."""
    return {"captures": dict(_graph.captures), "replays": dict(_graph.replays)}


def traced_window(cell: str, seed: int, seconds: float):
    """(window, device ops on the host clock, the window's spans, the
    graphs' counts before and after the window)."""
    _, _, config, traffic = harness.cell_spec(cell)
    device = torch.device("cuda", 0)
    sut = importlib.import_module(f"perfbench.systems.{config['system']}").Cell(config, traffic, seed, device)
    sut.setup()
    torch.cuda.synchronize(device)
    profiler.clear_spans()
    rec = Window()
    graphs = track_graphs()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        marker = now()
        torch.empty(1, device=device).fill_(0.0)
        sut.window(seconds, rec)
        torch.cuda.synchronize(device)
    ops = tr.clip(tr.kineto_ops(prof, marker), rec.start, rec.end)
    return rec, ops, [s for s in profiler.spans() if rec.start <= s.t0 < rec.end], (graphs, track_graphs())


def innermost(records, t: float):
    """The shortest span holding time t, or None."""
    holding = [s for s in records if s.t0 <= t < s.t1]
    return min(holding, key=lambda s: s.t1 - s.t0) if holding else None


def graph_counts(before: dict, after: dict) -> dict:
    """The graphs' captures and replays in all and inside the window, by
    the captured function."""
    return {kind: {"total": now, "window": {k: v - before[kind].get(k, 0) for k, v in now.items()
                                            if v != before[kind].get(k, 0)}}
            for kind, now in after.items()}


def breakdown(rec, ops, records, graphs, gap_ms: float) -> dict:
    union = sp.merged(ops)
    starts = [a for a, _ in union]
    units = rec.units
    stages = {}
    for name in sorted({s.name for s in records}):
        mine = [s for s in records if s.name == name]
        wall = sum(s.t1 - s.t0 for s in mine)
        busy = sum(sp.busy_in(union, starts, s.t0, s.t1) for s in mine)
        launches = {}
        for s in mine:
            for k, v in s.launches.items():
                launches[k] = launches.get(k, 0) + v
        stages[name] = {"count": len(mine), "host_ms": 1e3 * wall / units,
                        "cpu_ms": 1e3 * sum(s.cpu_s for s in mine) / units,
                        "offcpu_ms": 1e3 * sum(s.t1 - s.t0 - s.cpu_s for s in mine) / units,
                        "nivcsw": sum(s.nivcsw or 0 for s in mine),
                        "device_idle_pct": 100.0 * (1.0 - busy / wall) if wall > 0 else None,
                        "launches": launches}
    roots = [s for s in records if s.parent is None]
    by_parent = {}
    for s in records:
        by_parent.setdefault(s.parent, []).append(s)
    root_ms = 1e3 * sum(r.t1 - r.t0 for r in roots) / units
    child_share = max((sum(c.t1 - c.t0 for c in by_parent.get(r.id, [])) / (r.t1 - r.t0) for r in roots), default=None)

    def describe(s):
        return {"span": s.name, "wall_ms": 1e3 * (s.t1 - s.t0), "cpu_ms": 1e3 * s.cpu_s, "nivcsw": s.nivcsw}

    stalls = []
    for a, b, last in tr.gaps(ops, rec.start, rec.end):
        if b - a >= gap_ms / 1e3:
            s = innermost(records, (a + b) / 2)
            stalls.append({"gap_ms": 1e3 * (b - a), "after": last[:80], "at_s": a - rec.start,
                           **(describe(s) if s else {"span": "harness"})})
    walls = sorted(1e3 * (r.t1 - r.t0) for r in roots)
    long_units = [{"root": describe(r), "stages": [describe(c) for c in sorted(by_parent.get(r.id, []),
                                                                            key=lambda c: c.t0)]}
                  for r in roots if 1e3 * (r.t1 - r.t0) >= gap_ms]
    return {"units": units, "window_s": rec.seconds, "calls": len(rec.calls), "spans": len(records),
            "spans_dropped": profiler.spans_dropped(), "device_ops": len(ops),
            "annotation_ops": sum(o.name in stages for o in ops),
            "device_idle_pct": 100.0 * (1.0 - tr.union_s(ops) / rec.seconds),
            "host_call_ms": 1e3 * rec.entry_s / units, "root_host_ms": root_ms,
            "largest_child_share": child_share,
            "root_wall_ms": {"median": statistics.median(walls), "max": walls[-1],
                             "p95": statistics.quantiles(walls, n=100, method="inclusive")[94] if len(walls) > 1 else walls[0]},
            "stages": stages, "track_graphs": graph_counts(*graphs), "stalls": stalls,
            "long_units": long_units}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    p.add_argument("--gap-ms", type=float, default=20.0)
    p.add_argument("--json")
    a = p.parse_args(argv)
    harness.configure_caches()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 3
    out = breakdown(*traced_window(a.workload, a.seed, a.seconds), a.gap_ms)
    out.update(workload=a.workload, seed=a.seed, device=torch.cuda.get_device_name(0))
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "long_units"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
