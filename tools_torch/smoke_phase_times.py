"""Wall time of ``chip_smoke.py``'s slower phases on the card, split by step.

Builds the three kernels as ``chip_smoke.main`` does, then runs the SLAM
scene, ``run_odometry_paths``, ``run_slam_paths``, ``run_tracker``,
``run_facade`` and ``run_person_tracker`` with a synchronized timer
around each of their steps (``system.run_slam``, ``frames_per_s``,
``slam_stage_times``, ``host_syncs``, ``slam_profile``,
``device_profile``, ...). Prints one ``phase:`` line a phase: its wall
time and each step's total and call count. Before the phases it holds
``chip_smoke.device_events`` against ``torch.profiler``'s ``events()``
on one profile of 8 SLAM steps (events, summed µs, names) and times both.
With ``--bench-scripts`` it runs the phases of the four per-path scripts
instead (``run_stage_profile``, ``run_facade_profile``,
``run_sweep_config``, ``run_decay_sweep``), timing the cuboid and odometry
stages, each facade subset, each config variant and each SLAM run.

Needs a CUDA card. Run from the repository root:
``python3 tools_torch/smoke_phase_times.py [--bench-scripts]``
"""

from __future__ import annotations

import collections
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from perception_tpu_torch.models.slam import system  # noqa: E402
from perception_tpu_torch.ops.kernels import build  # noqa: E402

STEPS = ("frames_per_s", "slam_stage_times", "host_syncs", "check_host_syncs", "slam_profile", "device_profile",
         "compare_datum", "facade_stage_ms")
totals, calls = collections.defaultdict(float), collections.Counter()


def time_steps(module, name, label):
    """Wrap ``module.name`` in a synchronized timer that adds to ``label``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        totals[label] += time.perf_counter() - t0
        calls[label] += 1
        return out

    setattr(module, name, wrapper)


def report(label, t0):
    steps = ", ".join(f"{k} {v:.1f} s x{calls[k]}" for k, v in totals.items())
    print(f"phase: {label} {time.perf_counter() - t0:.1f} s; {steps}", flush=True)
    totals.clear()
    calls.clear()


def check_device_events(device, scene):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    camera, _, grays, depths = scene
    d, g = torch.from_numpy(depths[:8]).to(device), torch.from_numpy(grays[:8]).to(device)
    cfg = next(iter(cs.slam_configs().values()))
    system.run_slam(camera, d, g, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.run_slam(camera, d, g, cfg)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = cs.device_events(prof)
    t1 = time.perf_counter()
    tree = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events() if e.device_type == DeviceType.CUDA]
    t2 = time.perf_counter()
    by_raw, by_tree = collections.Counter(), collections.Counter()
    for name, us in raw:
        by_raw[name] += us
    for name, us in tree:
        by_tree[name] += us
    differ = [k for k in set(by_raw) | set(by_tree) if abs(by_raw[k] - by_tree[k]) > 1e-6]
    print(f"device_events: {len(raw)} events, {sum(by_raw.values()):.3f} us, read in {t1 - t0:.2f} s; "
          f"prof.events(): {len(tree)} events, {sum(by_tree.values()):.3f} us, read in {t2 - t1:.2f} s; "
          f"names whose sums differ: {len(differ)}", flush=True)


def bench_scripts(device) -> None:
    from perception_tpu_torch.bench import facade_profile, profile_stages, slam_bench, sweep_config

    for module, name in ((profile_stages, "cuboid_stages"), (profile_stages, "odometry_stages"),
                         (facade_profile, "time_engine"), (sweep_config, "run_variant"), (slam_bench, "run")):
        time_steps(module, name, f"{module.__name__.rsplit('.', 1)[-1]}.{name}")
    for phase in (cs.run_stage_profile, cs.run_facade_profile, cs.run_sweep_config, cs.run_decay_sweep):
        t0 = time.perf_counter()
        phase(device)
        report(phase.__name__, t0)


def main() -> None:
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(build.build, cs.KERNELS))
    for name in cs.KERNELS:
        build.load_library(name)
    if "--bench-scripts" in sys.argv[1:]:
        bench_scripts(device)
        return
    for name in STEPS:
        time_steps(cs, name, name)
    time_steps(system, "run_slam", "system.run_slam")

    t0 = time.perf_counter()
    scene = cs.slam_scene()
    report("slam_scene", t0)
    check_device_events(device, scene)
    for phase, args in ((cs.run_odometry_paths, (device, scene)), (cs.run_slam_paths, (device, scene)),
                        (cs.run_tracker, (device,)), (cs.run_facade, (device,)), (cs.run_person_tracker, (device,))):
        t0 = time.perf_counter()
        phase(*args)
        report(phase.__name__, t0)


if __name__ == "__main__":
    main()
