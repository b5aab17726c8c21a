"""Streaming multi-cuboid tracking benchmark.

Counterpart of ``benchmarks/tracking_bench.py``'s ``run``: a 300-frame
synthetic bag (three cuboids on a table under a moving camera,
``bench/tracking_scene.py``) replayed through the streaming tracker
(``models/object_tracking.py``) in the JAX benchmark's configuration, with
the frames staged on the device beforehand. It reports

  tracking_fps   frames/s of ``track_step_from_depth`` after a warm-up
                 step (host clock, ending in a synchronize on the card)
  median_err_cm  median translation error of latched slots against the
                 ground truth; ``p90_err_cm`` its 90th percentile
  latched_pct    share of (frame, slot) pairs latched
  warm_pct       share of latched updates carried by the warm row

and the frame count, object count and resolution. ``cli bench`` reports
it under ``extra["objects_tracking"]``.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perception_tpu_torch.bench.timing import sync


def bench_camera(width: int = 640, height: int = 480):
    """The benchmark's camera: fx 384 at 640 wide, centred."""
    from perception_tpu_torch.geometry.camera import PinholeCamera

    fx = 384.0 * width / 640.0
    return PinholeCamera.from_K([fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1], width=width, height=height)


def bench_templates():
    """The three cuboids' templates (6 mm density), padded to one length:
    (templates (3, Nt, 3) float32, masks (3, Nt) bool)."""
    from perception_tpu_torch.bench.tracking_scene import CUBOID_SET
    from perception_tpu_torch.io.templates import cuboid_template

    tmpls = [cuboid_template(*dims, density=0.006) for dims, _ in CUBOID_SET]
    nt = max(len(t) for t in tmpls)
    templates, masks = np.zeros((len(tmpls), nt, 3), np.float32), np.zeros((len(tmpls), nt), bool)
    for k, t in enumerate(tmpls):
        templates[k, :len(t)], masks[k, :len(t)] = t, True
    return templates, masks


def bench_config():
    """The benchmark's TrackingConfig (benchmarks/tracking_bench.py: 5 mm
    voxels, a decimation-aware min_size, capacities sized to the tabletop,
    24 warm ICP iterations)."""
    from perception_tpu_torch.models.object_tracking import TrackingConfig
    from perception_tpu_torch.models.objects import ObjectConfig

    det = ObjectConfig(table_z_cut=0.9, z_limits=(0.0, 0.9), x_limits=(-0.35, 0.35), voxel_size=0.005,
                       cluster_min_size=40, cluster_capacity=1024, offplane_capacity=2048, work_capacity=24576)
    return TrackingConfig(detection=det, max_tracks=3, warm_icp_iterations=24)


def render_frames(camera, frames: int):
    """``camera_trajectory(frames)`` rendered (frames in parallel, seed =
    frame index): (depths (frames, H, W) float32, gt (frames, 3, 4, 4))."""
    from perception_tpu_torch.bench.tracking_scene import camera_trajectory, render_depth_cuboids

    traj = camera_trajectory(frames)
    with ThreadPoolExecutor(8) as pool:
        out = list(pool.map(lambda i: render_depth_cuboids(camera, traj[i], seed=i), range(frames)))
    return np.stack([d for d, _ in out]), np.stack([np.stack(g) for _, g in out])


def run(frames: int = 300, width: int = 640, height: int = 480, device="cuda") -> dict:
    from perception_tpu_torch.models.object_tracking import (
        init_tracks,
        slot_template_normals,
        track_step_from_depth,
    )

    device = torch.device(device)
    camera = bench_camera(width, height)
    cfg = bench_config()
    templates_np, masks_np = bench_templates()
    templates, masks = torch.from_numpy(templates_np).to(device), torch.from_numpy(masks_np).to(device)
    # The template normals once, not every frame.
    tn = slot_template_normals(templates, masks)
    depths_np, gts = render_frames(camera, frames)
    depths = torch.from_numpy(depths_np).to(device)

    def step(slots, depth, gen):
        return track_step_from_depth(slots, depth, camera, templates, masks, gen, cfg, template_normals=tn)

    warm, _ = step(init_tracks(cfg, device), depths[0], torch.Generator(device=device).manual_seed(1))
    sync(warm.pose)

    slots = init_tracks(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    hist = []
    t0 = time.perf_counter()
    for i in range(frames):
        slots, diag = step(slots, depths[i], gen)
        hist.append((slots.pose, slots.latched, diag.used_warm))
    sync(slots.pose)
    dt = time.perf_counter() - t0

    pose = torch.stack([h[0] for h in hist]).cpu().numpy()
    latched = torch.stack([h[1] for h in hist]).cpu().numpy()
    used_warm = torch.stack([h[2] for h in hist]).cpu().numpy()
    errs = np.linalg.norm(pose[..., :3, 3] - gts[..., :3, 3], axis=-1)[latched]
    K = cfg.max_tracks
    return {
        "tracking_fps": frames / dt,
        "median_err_cm": float(np.median(errs) * 100.0) if len(errs) else float("nan"),
        "p90_err_cm": float(np.percentile(errs, 90) * 100.0) if len(errs) else float("nan"),
        "latched_pct": 100.0 * int(latched.sum()) / max(frames * K, 1),
        "warm_pct": 100.0 * int(used_warm.sum()) / max(int(latched.sum()), 1),
        "frames": frames,
        "objects": K,
        "resolution": f"{width}x{height}",
    }
