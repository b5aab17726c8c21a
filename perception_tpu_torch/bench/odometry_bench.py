"""Odometry throughput benchmark: dense point-to-plane odometry at 640x480.

Counterpart of ``benchmarks/odometry_bench.py`` ("the second number the
north star cares about", after the headline): ``models/slam/odometry``'s
``odometry_step`` on the D435 depth camera over a 10-frame synthetic room
sweep (five planes, 2 mm of seeded depth noise), in the default keyframe
mode at two budget pairs (4096 source points against an 8192-point
keyframe, and 8192 against 32768), each on the op graph
(``fused_gn="off"``) and on the fused Gauss-Newton kernel K2
(``fused_gn="on"``, ``csrc/icp_gn.cu``). Each configuration takes one
warm-up step from frame 0 to frame 1, then ``timed_frames`` steps over
the sweep's frames in turn, staged on the device beforehand (host clock,
ending in a synchronize on the card). It reports, per budget pair and
mode, frames/s and ms a frame, the warm-up step's overlap and the last
step's pose (the two modes find the same neighbours, so their poses
agree), and per budget pair the fused speedup (K2's frames/s over the op
graph's). The JAX benchmark keeps its results in a dict keyed (keyframe
budget, mode) and prints them; ``run`` returns them under string keys
"<point budget>x<keyframe budget> <mode>".

Run: ``python -m perception_tpu_torch.bench.odometry_bench [--cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import device_of, sync

BUDGETS = ((4096, 8192), (8192, 32768))  # (point_budget, keyframe_budget)
MODES = ("off", "on")
LABELS = {"off": "op graph", "on": "CUDA fused GN (K2)"}
SWEEP_FRAMES = 10
TIMED_FRAMES = 40
# The room: (plane normal, offset) pairs; the floor and ceiling at 0.9 m,
# the back wall at 3 m, the side walls at 1.5 m.
PLANES = (((0, 1.0, 0), 0.9), ((0, -1.0, 0), 0.9), ((0, 0, 1.0), 3.0), ((1.0, 0, 0), 1.5), ((-1.0, 0, 0), 1.5))


def render(camera, T_wc, seed: int) -> np.ndarray:
    """Depth (H, W) float32 of the room from the camera at ``T_wc``, with
    2 mm of noise from ``np.random.RandomState(seed)``; 0 where no plane
    is hit."""
    H, W = camera.height, camera.width
    fx, fy, cx, cy = float(camera.fx), float(camera.fy), float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1)
    T = np.asarray(T_wc, np.float64)
    o, d = T[:3, 3], rays @ T[:3, :3].T
    depth = np.full((H, W), np.inf)
    for n, c in PLANES:
        n = np.asarray(n)
        denom = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c - o @ n) / denom
        t = np.where((t > 0.1) & (denom != 0), t, np.inf)
        depth = np.minimum(depth, np.where(np.isfinite(t), t * rays[..., 2], np.inf))
    depth[~np.isfinite(depth)] = 0.0
    rng = np.random.RandomState(seed)
    return (depth + rng.randn(H, W) * 0.002).astype(np.float32)


def sweep_pose(i: int) -> np.ndarray:
    """The camera at sweep frame ``i``: ``se3_exp`` of the float32 twist
    (0.01 i, 0, 0.005 i, 0, 0.004 i, 0), through the port's float32
    ``se3_exp``, as float64."""
    from perception_tpu_torch.geometry import se3

    tw = torch.tensor([0.01 * i, 0.0, 0.005 * i, 0.0, 0.004 * i, 0.0], dtype=torch.float32)
    return se3.se3_exp(tw).numpy().astype(np.float64)


def sweep_frames(camera, n: int = SWEEP_FRAMES) -> np.ndarray:
    """The sweep's ``n`` depth frames, (n, H, W) float32, frame i with seed i."""
    return np.stack([render(camera, sweep_pose(i), i) for i in range(n)])


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(timed_frames: int = TIMED_FRAMES, budgets=BUDGETS, device="cuda") -> dict:
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step

    device = device_of(device)
    cam = PinholeCamera.d435_depth()
    frames = torch.from_numpy(sweep_frames(cam)).to(device)
    sync(frames)
    fps, ms, overlap, speedup, final = {}, {}, {}, {}, {}
    for pt_budget, kf_budget in budgets:
        budget = f"{pt_budget}x{kf_budget}"
        for mode in MODES:
            cfg = dataclasses.replace(OdometryConfig(), fused_gn=mode, point_budget=pt_budget,
                                      keyframe_budget=kf_budget)
            state = init_state(cam, frames[0], cfg)
            state, diag = odometry_step(state, frames[1], cam, cfg)
            sync(state.pose)
            key = f"{budget} {mode}"
            overlap[key] = float(diag.overlap)
            _log(f"warmup[{mode}] overlap={overlap[key]:.2f}")

            t0 = time.perf_counter()
            for i in range(timed_frames):
                state, diag = odometry_step(state, frames[i % len(frames)], cam, cfg)
            sync(state.pose)
            dt = time.perf_counter() - t0
            fps[key], ms[key] = timed_frames / dt, dt / timed_frames * 1000.0
            final[key] = state.pose.cpu().tolist()
            print(f"odometry[{LABELS[mode]}]: {fps[key]:.1f} frames/s ({ms[key]:.2f} ms/frame) at "
                  f"{cam.width}x{cam.height}, budget={pt_budget} pts vs kf {kf_budget} (auto->op graph)", flush=True)
        speedup[budget] = fps[f"{budget} on"] / fps[f"{budget} off"]
        print(f"fused speedup at {budget}: {speedup[budget]:.2f}x", flush=True)
    return {
        "frames_per_s": fps,
        "ms_per_frame": ms,
        "warmup_overlap": overlap,
        "fused_speedup": speedup,
        "final_pose": final,
        "timed_frames": timed_frames,
        "resolution": f"{cam.width}x{cam.height}",
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    run(device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
