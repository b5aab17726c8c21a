"""One run of one cell: set-up, a timed window, the check, the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration file;
``perfbench/workloads/<cell>.json`` is its traffic;
``perfbench/systems/<system>.py`` drives the configuration's kind of
system; ``perfbench/metrics/<metric>.py`` reads one metric from what the
window recorded (``read(ctx)`` returns a number, or None where it finds
nothing to read).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

from perfbench import trace as tr
from perfbench.systems.record import Window, now

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "perception_tpu")
# A traced run's window is cut to this: the profiler's cost grows with the
# events (~300 a cuboid frame), and the run, trace reading included, has
# to end within six minutes.
TRACE_SECONDS = 10.0


class NoDevice(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT):
    """(manifest, workload entry, configuration file's contents, traffic) of cell ``name``."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "perfbench" / "workloads" / f"{name}.json")
    return manifest, cell, config, traffic


def metrics_of(manifest: dict, cell: str, trace: bool):
    """The manifest's metrics that cell ``cell`` reports in this kind of run."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, device=None,
             root: Path = ROOT, edit=None):
    """Run cell ``name`` once; returns the result line's dict and the
    checks' lines. ``device`` None takes CUDA card 0 and fails without
    enough cards; ``edit(config, traffic)`` may change the cell (tests run
    it small on the CPU)."""
    import torch

    manifest, cell, config, traffic = cell_spec(name, root)
    if edit is not None:
        edit(config, traffic)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"cell {name} needs {cell['chips']} CUDA card(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    system = importlib.import_module(f"perfbench.systems.{config['system']}")
    sut = system.Cell(config, traffic, seed, device)
    t_setup = now()
    sut.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = now() - t_start
    marks = [("started", t_start), ("set-up entered", t_setup)] + list(getattr(sut, "times", {}).items())

    rec = Window()
    ops = None
    cpu0 = cpu_times()
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            marker = now()
            torch.empty(1, device=device).fill_(0.0)
            sut.window(min(seconds, TRACE_SECONDS), rec)
            torch.cuda.synchronize(device)
        ops = tr.clip(tr.kineto_ops(prof, marker), rec.start, rec.end)
        del prof
    else:
        sut.window(seconds, rec)
    cpu1 = cpu_times()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run's process: {', '.join(found)}")
    sut.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, compared = sut.check()
    limits = config["limits"]
    correct = set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in numbers)

    ctx = SimpleNamespace(cell=name, config=config, traffic=traffic, setup_s=setup_s, window=rec,
                          ops=ops, kernel_shapes=sut.kernel_shapes())
    metrics = {}
    for m in metrics_of(manifest, name, trace):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # A closed-loop caller waits for every answer, so none fails to come;
    # a wrong one makes ``correct`` false.
    result = {"correct": bool(correct), "attempted": rec.units, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if ops is not None:
        result["device"]["busy_s"] = tr.union_s(ops)
        result["device"]["window_s"] = rec.seconds
        result["breakdown"] = breakdown(ops, rec)
    lines = ["set-up: " + ", ".join(f"{b} {tb - ta:.3f} s" for (_, ta), (b, tb) in zip(marks, marks[1:])),
             "host: " + host_load(cpu0, cpu1, rec),
             "window, ms a unit in each second: " + timeline(rec)]
    if getattr(sut, "detail", None):
        lines.append("worst answer: " + json.dumps(sut.detail))
    lines.append(f"compared {compared} answers of {rec.units} in the window")
    lines += [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in numbers]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return result, lines, rec


def breakdown(ops, rec: Window) -> dict:
    """The ten device operations with the most time, and the ten longest
    idle gaps, each named by what the host was doing and the operation
    before it."""
    by_name = tr.seconds_by_name(ops)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(tr.gaps(ops, rec.start, rec.end), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[name[:120], s] for name, (s, _) in top],
            "idle_gaps": [[f"{tr.phase_at(rec.spans, (a + b) / 2)}; after {last[:80]}", b - a]
                          for a, b, last in gaps]}


def cpu_times():
    """This process's CPU seconds so far (user + system, all threads)."""
    t = os.times()
    return t.user + t.system


def host_load(cpu0: float, cpu1: float, rec: Window) -> str:
    """The host's load average, this process's CPUs, and the CPU time it
    took over the window as a share of one CPU, for the record."""
    try:
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError:
        load = "unknown"
    return (f"load average {load}; {len(os.sched_getaffinity(0))} CPUs for this process of "
            f"{os.cpu_count()}; over the window it took {100 * (cpu1 - cpu0) / rec.seconds:.0f}% of one CPU")


def timeline(rec: Window) -> str:
    """Mean milliseconds a unit of the calls that ended in each second of
    the window (a slow second shows where the host stalled)."""
    acc = {}
    for t0, t1, n in rec.calls:
        acc.setdefault(int(t1 - rec.start), []).append((t1 - t0, n))
    return " ".join(f"{1e3 * sum(d for d, _ in v) / sum(n for _, n in v):.2f}" for _, v in sorted(acc.items()))


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result, lines, rec = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    except NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    for k, m in result["metrics"].items():
        n = len(rec.latencies) if k.endswith("_p95_ms") else rec.units
        print(f"{k}: {m['value']!r} {m['unit']} over {n} samples in {rec.seconds:.3f} s", file=sys.stderr)
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def configure_caches(root: Path = ROOT):
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "perfbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "perfbench" / "triton")
