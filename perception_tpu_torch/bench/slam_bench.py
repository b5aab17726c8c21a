"""SLAM benchmark: ATE and throughput over the revisit sweep.

Counterpart of ``benchmarks/slam_bench.py``'s ``run``: the full keyframe
SLAM system (dense ICP odometry, landmark tracks, sliding-window BA,
loop closure, pose-graph correction) over the synthetic textured-room
sweep of ``bench/slam_scene.py`` (300 frames, several revisits), in the
JAX benchmark's configuration. It reports

  ate_cm         RMSE absolute trajectory error vs ground truth (cm, no
                 alignment)
  slam_fps       full-system frames/s after a warm-up step, frames staged
                 on the device beforehand (host clock, ends in a
                 ``torch.cuda.synchronize`` on the card)
  loop_closures  verified loop-closure edges live at the end
  ba_runs        sliding-window bundle-adjust runs

and the counts of the JAX benchmark's dict. ``cli slam`` without
``--tum`` runs it.

Run: ``python -m perception_tpu_torch.bench.slam_bench [--cpu]``
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

# benchmarks/slam_bench.py's odometry settings.
BENCH_ODOM = dict(point_budget=2048, keyframe_budget=4096, icp_iterations=8, min_depth=0.1,
                  max_depth=6.0, normal_max_edge=0.1, kf_translation=0.10, kf_rotation=0.12)


def bench_config(enable_ba: bool = True, map_budget: int = 0, map_nn: str = "auto", **odom_overrides):
    """The benchmark's SlamConfig; ``odom_overrides`` land on OdometryConfig."""
    from perception_tpu_torch.models.slam.odometry import OdometryConfig
    from perception_tpu_torch.models.slam.system import SlamConfig

    odom = dict(BENCH_ODOM, map_budget=map_budget, map_nn=map_nn)
    odom.update(odom_overrides)
    return SlamConfig(
        odometry=OdometryConfig(**odom),
        max_keyframes=64,
        max_edges=192,
        features_per_kf=256,
        fast_threshold=15.0,
        lc_min_gap=3,
        lc_min_matches=20,
        lc_min_inliers=10,
        enable_ba=enable_ba,
    )


def bench_camera(width: int = 640, height: int = 480):
    from perception_tpu_torch.geometry.camera import PinholeCamera

    fx = 307.0 * width / 320.0
    return PinholeCamera.from_K([fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1],
                                width=width, height=height)


@functools.lru_cache(maxsize=1)
def rendered_sequence(frames: int, width: int, height: int):
    """The sweep at ``width`` x ``height``: (camera, gt (frames, 4, 4)
    float64, grays, depths (frames, H, W) float32), rendered once and kept
    for the next call with the same sizes, so the benchmark's three
    configurations share one render (``benchmarks/slam_bench.py``'s
    ``rendered_sequence``). The arrays are shared: callers copy before
    writing."""
    from perception_tpu_torch.bench.slam_scene import render_sequence, sweep_trajectory

    camera = bench_camera(width, height)
    gt = np.stack(sweep_trajectory(n=frames))
    grays, depths = render_sequence(camera, gt)
    return camera, gt, np.stack(grays), np.stack(depths)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    frames: int = 300,
    width: int = 640,
    height: int = 480,
    enable_ba: bool = True,
    map_budget: int = 0,
    map_nn: str = "auto",
    device="cuda",
    **odom_overrides,
) -> dict:
    from perception_tpu_torch.models.slam.system import slam_init, slam_step
    from perception_tpu_torch.utils.metrics import ate

    device = torch.device(device)
    camera, gt, grays, depths = rendered_sequence(frames, width, height)
    cfg = bench_config(enable_ba, map_budget, map_nn, **odom_overrides)
    dj = torch.from_numpy(depths).to(device)
    gj = torch.from_numpy(grays).to(device)

    # Warm up with one step so the timed loop is steady-state.
    state = slam_init(camera, dj[0], gj[0], cfg)
    slam_step(state, dj[1], gj[1], camera, torch.Generator(device=device).manual_seed(0), cfg)
    _sync(device)

    generator = torch.Generator(device=device).manual_seed(0)
    poses, flags, ba_flags = [torch.eye(4, device=device)], [], []
    t0 = time.perf_counter()
    for i in range(1, frames):
        state, diag = slam_step(state, dj[i], gj[i], camera, generator, cfg)
        poses.append(state.odom.pose)
        flags.append(state.loop_found)
        ba_flags.append(diag.ba_ran)
    _sync(device)
    dt = time.perf_counter() - t0

    est = torch.stack(poses).cpu().numpy().astype(np.float64)
    res = ate(est, gt, align=False)
    loop_edges = int(((state.edges.weight == 2.0) & state.edges.mask).sum())
    return {
        "ate_cm": float(res.rmse * 100.0),
        "slam_fps": (frames - 1) / dt,
        "loop_closures": loop_edges,
        "pose_graph_corrections": int(torch.stack(flags).sum()),
        "ba_runs": int(torch.stack(ba_flags).sum()),
        "landmarks": int(state.landmarks.mask.sum()),
        "observations": int(state.obs.mask.sum()),
        "frames": frames,
        "keyframes": int(state.keyframes.count),
        "resolution": f"{width}x{height}",
        "map_budget": map_budget,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--frames", type=int, default=300)
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    for label, kwargs in (
        ("keyframe+BA", dict(enable_ba=True)),
        ("keyframe, no BA", dict(enable_ba=False)),
        ("map-fusion 32k", dict(enable_ba=True, map_budget=32768)),
    ):
        out = run(frames=args.frames, device=device, **kwargs)
        print(f"--- {label} ---")
        for k, v in out.items():
            print(f"{k}: {v}")


if __name__ == "__main__":
    main()
