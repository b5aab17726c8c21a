"""Sweep cuboid-pipeline capacities and restarts on the card: acceptance
across all bench scenes (must stay 8 of 8) and steady-state frames/s.

Counterpart of ``benchmarks/sweep_config.py``: seven ``CuboidConfig``
variants (``variants()``) over the 8 bench scenes (``bench/scene.bench_frames``:
the JAX script's twists, yaw 0.3 + 0.05 s, seeds 0-7). Each variant runs
``cuboid_pipeline_from_depth`` once a scene (acceptance and the largest
fitness), then 48 timed calls over the scenes in turn (host clock, ending
in a synchronize on the card). The RANSAC triplets of call i come from a
CPU ``torch.Generator`` seeded i (scenes) or 1000 + i (timed calls), made
before the clock, so the card and the CPU draw the same triplets. It
prints the JAX script's line a variant::

  <name>       fps=<frames/s>  acc=<accepted>/8  fitness_max=<largest fitness>

and ``<name>       FAILED: <error>`` for a variant that raises. The JAX
script keeps sweeping past a failure and exits 0; here the sweep also goes
on, and ``main`` exits 1 at the end if any variant failed.

Run: ``python -m perception_tpu_torch.bench.sweep_config [--cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import device_of, sync

TIMED = 48
_CAPS = dict(box_capacity=1024, template_capacity=1280)


def variants():
    """The JAX script's seven (name, CuboidConfig) pairs, in its order."""
    from perception_tpu_torch.models.cuboid import CuboidConfig

    base = CuboidConfig()
    r = dataclasses.replace
    return [
        ("base", base),
        ("boxtmpl1k", r(base, **_CAPS)),
        ("restarts4", r(base, **_CAPS, icp_restarts=4)),
        ("work8k", r(base, **_CAPS, icp_restarts=4, work_capacity=8192)),
        ("iters14", r(base, **_CAPS, icp_restarts=4, work_capacity=8192, icp_max_iterations=14)),
        ("pre32k", r(base, **_CAPS, icp_restarts=4, work_capacity=8192, pre_capacity=32768)),
        ("hyp512", r(base, **_CAPS, icp_restarts=4, work_capacity=8192, ransac_hypotheses=512)),
    ]


def scenes():
    """(camera, template points, the 8 bench depths (8, H, W) float32)."""
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera

    camera = PinholeCamera.d435_depth()
    return camera, benchmark_template(), bench_frames(camera)[0]


def run_variant(name, config, camera, template_np, frames, device="cuda", timed=TIMED) -> dict:
    """Acceptance, fitness and frames/s of one variant; prints its line."""
    from perception_tpu_torch.models.cuboid import cuboid_pipeline_from_depth, template_features

    device = device_of(device)
    template, tnormals, tmask = template_features(template_np, np.ones(len(template_np), bool), config,
                                                  device=device)

    def fn(d, g):
        return cuboid_pipeline_from_depth(d, camera, template, tmask, g, config, template_normals=tnormals)

    dev = [torch.from_numpy(f).to(device) for f in frames]
    acc, fit = [], []
    for i, d in enumerate(dev):
        r = fn(d, torch.Generator().manual_seed(i))
        acc.append(bool(r.accepted))
        fit.append(float(r.fitness))

    gens = [torch.Generator().manual_seed(1000 + i) for i in range(timed)]
    sync(dev)
    t0 = time.perf_counter()
    out = None
    for i in range(timed):
        out = fn(dev[i % len(dev)], gens[i])
    sync(out)
    fps = timed / (time.perf_counter() - t0)
    print(f"{name:12s} fps={fps:7.2f}  acc={sum(acc)}/{len(acc)}  fitness_max={max(fit):.6f}", flush=True)
    return {"config": name, "fps": fps, "accepted": acc, "fitness": fit}


def run(device="cuda", timed=TIMED) -> list:
    """Every variant in turn; a variant that raises gives ``{"config": name,
    "error": message}`` and the sweep goes on."""
    device = device_of(device)
    camera, template_np, frames = scenes()
    rows = []
    for name, cfg in variants():
        try:
            rows.append(run_variant(name, cfg, camera, template_np, frames, device, timed))
        except Exception as e:  # keep sweeping
            print(f"{name:12s} FAILED: {e}", flush=True)
            rows.append({"config": name, "error": str(e)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    rows = run(device="cpu" if args.cpu else "cuda")
    failed = [r["config"] for r in rows if "error" in r]
    if failed:
        print(f"sweep_config: {len(failed)} variant(s) failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
