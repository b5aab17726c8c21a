"""The SLAM bench's three configurations in both packages, on the CPU.

Runs ``benchmarks/slam_bench.py``'s ``run`` (the JAX package) and the
port's ``perception_tpu_torch/bench/slam_bench.py`` ``run`` (on the CPU)
over the same 640x480 textured-room sweep at the configurations ``bench.py``
reports: keyframe mode with BA, keyframe mode without BA, and map fusion
at map_budget 32768. Prints one JSON line per package and configuration:
ATE (cm), live loop-closure edges, pose-graph corrections, keyframes, BA
runs, landmarks, observations and the wall time of the call. The RANSAC
streams differ (``jax.random`` against a ``torch.Generator``), so the
two are compared as results, not bits.

Each configuration can run in a process of its own (``--config``), so the
six runs spread over the host's cores.

Run from the repository root:
``JAX_PLATFORMS=cpu python3 tools_torch/slam_bench_compare.py [--frames 300] [--package jax|torch|both] [--config ba|no_ba|map|all] [--threads N]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONFIGS = {  # bench.py's three SLAM rows
    "ba": dict(enable_ba=True),
    "no_ba": dict(enable_ba=False),
    "map": dict(enable_ba=True, map_budget=32768),
}
KEYS = ("ate_cm", "loop_closures", "pose_graph_corrections", "keyframes", "ba_runs", "landmarks",
        "observations", "frames", "resolution", "map_budget")


def run(package: str, config: str, frames: int) -> dict:
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from benchmarks.slam_bench import run as bench_run

        kwargs = {}
    else:
        from perception_tpu_torch.bench.slam_bench import run as bench_run

        kwargs = {"device": "cpu"}
    t0 = time.perf_counter()
    out = bench_run(frames=frames, **CONFIGS[config], **kwargs)  # at 640x480, both runs' default
    return {"package": package, "config": config, **{k: out[k] for k in KEYS},
            "seconds": round(time.perf_counter() - t0, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--package", choices=("jax", "torch", "both"), default="both")
    ap.add_argument("--config", choices=(*CONFIGS, "all"), default="all")
    ap.add_argument("--threads", type=int, default=0, help="torch threads (0: torch's default)")
    args = ap.parse_args()
    if args.threads:
        import torch

        torch.set_num_threads(args.threads)
    packages = ("torch", "jax") if args.package == "both" else (args.package,)
    configs = tuple(CONFIGS) if args.config == "all" else (args.config,)
    for config in configs:
        for package in packages:
            print(json.dumps(run(package, config, args.frames)), flush=True)


if __name__ == "__main__":
    main()
