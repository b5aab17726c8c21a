"""Multi-object service benchmark: steady-state ``detect_object`` latency.

Counterpart of ``benchmarks/objects_bench.py``'s ``run``: the detection
service (filters, plane removal with the RANSAC kernel K1, clustering,
batched cluster x restart ICP, the winner's gate) on the 640x480 clutter
scene (``bench/clutter_scene.py``, seed 3) from the D435 depth camera,
against each class's captured template, at the JAX benchmark's
``ObjectConfig(cluster_min_size=40, size_gate=250)``. Per class one
warm-up call, then ``reps`` timed calls (host clock, ending in a
synchronize on the card), each with its own seeded generator where the
JAX benchmark passes ``jax.random.key(i)`` (made before the clock
starts). It reports

  per_class_ms  mean ms a call per class
  mean_ms       their mean
  successes     classes whose last call succeeded
  classes       the class count

The reference's service is a one-shot ROS RPC of sequential PCL (KD-tree
clustering, up to 10 ICP restarts a cluster); here the whole service is
one call on the device.

Run: ``python -m perception_tpu_torch.bench.objects_bench [--cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import device_of, sync

CLASSES = ("eraser", "screwdriver", "clamp", "marker")
SCENE_SEED = 3
REPS = 5


def bench_config():
    """The benchmark's ObjectConfig: minimum cluster size and size gate
    scaled to the full-resolution scene's 4 mm voxels."""
    from perception_tpu_torch.models.objects import ObjectConfig

    return ObjectConfig(cluster_min_size=40, size_gate=250)


def scene():
    """(camera, clutter poses by class, depth (480, 640) float32): the D435
    depth camera and the clutter scene at ``SCENE_SEED``."""
    from perception_tpu_torch.bench.clutter_scene import render_depth_clutter, standard_clutter_poses
    from perception_tpu_torch.geometry.camera import PinholeCamera

    camera = PinholeCamera.d435_depth()
    poses = standard_clutter_poses()
    return camera, poses, render_depth_clutter(camera, poses, seed=SCENE_SEED)


def run(classes=CLASSES, reps: int = REPS, device="cuda") -> dict:
    from perception_tpu_torch.bench.clutter_scene import captured_template
    from perception_tpu_torch.models.objects import detect_object

    device = device_of(device)
    camera, _, depth = scene()
    pts, mask = camera.backproject_depth(torch.from_numpy(depth).to(device))
    cfg = bench_config()

    per_class_ms = {}
    succ = 0
    for name in classes:
        tmpl = torch.from_numpy(captured_template(name, camera)).to(device)
        tm = torch.ones(len(tmpl), dtype=torch.bool, device=device)
        res = detect_object(pts, mask, tmpl, tm, torch.Generator(device=device).manual_seed(0), cfg)
        sync(res.pose)
        gens = [torch.Generator(device=device).manual_seed(i) for i in range(reps)]
        t0 = time.perf_counter()
        for gen in gens:
            res = detect_object(pts, mask, tmpl, tm, gen, cfg)
        sync(res.pose)
        per_class_ms[name] = round((time.perf_counter() - t0) / reps * 1000, 2)
        succ += int(bool(res.success))
    return {
        "per_class_ms": per_class_ms,
        "mean_ms": round(float(np.mean(list(per_class_ms.values()))), 2),
        "successes": succ,
        "classes": len(classes),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    for k, v in run(device="cpu" if args.cpu else "cuda").items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
