"""Synthetic SLAM scenes: a textured room and a revisit sweep, numpy only.

A copy of ``benchmarks/slam_scene.py`` that needs no JAX: the trajectory
poses come from the port's ``se3_exp`` on the CPU. The renderer is an
analytic ray-plane cast with world-anchored texture.
"""

from __future__ import annotations

import numpy as np
import torch

from perception_tpu_torch.geometry import se3


def render_textured_room(camera, T_wc, noise=0.001, seed=0, half_y=0.9,
                         wall_z=3.0, half_x=1.3):
    """(gray, depth) float32 (H, W) of a 5-plane room seen from T_wc."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays_c = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1)
    T = np.asarray(T_wc, np.float64)
    o = T[:3, 3]
    d = rays_c @ T[:3, :3].T

    depth = np.full((H, W), np.inf)
    world = np.zeros((H, W, 3))
    planes = [((0, 1.0, 0), half_y), ((0, -1.0, 0), half_y),
              ((0, 0, 1.0), wall_z), ((1.0, 0, 0), half_x), ((-1.0, 0, 0), half_x)]
    for n, c in planes:
        n = np.asarray(n)
        denom = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c - o @ n) / denom
        t = np.where((t > 0.1) & (denom != 0), t, np.inf)
        z = t * rays_c[..., 2]
        closer = z < depth
        depth = np.where(closer, z, depth)
        with np.errstate(invalid="ignore"):
            pw = o + np.where(np.isfinite(t)[..., None], t[..., None] * d, 0.0)
        world = np.where(closer[..., None], pw, world)

    cells = np.floor(world / 0.12).astype(np.int64)
    h = (cells[..., 0] * 73856093) ^ (cells[..., 1] * 19349663) ^ (cells[..., 2] * 83492791)
    gray = 60.0 + (np.abs(h) % 97) * 1.8

    depth[~np.isfinite(depth)] = 0.0
    rng = np.random.RandomState(seed)
    return gray.astype(np.float32), (depth + rng.randn(H, W) * noise).astype(np.float32)


def sweep_trajectory(n=300, x_amp=0.5, y_amp=0.15, yaw_amp=0.08, cycles=2.0):
    """Smooth multi-revisit sweep: the camera oscillates along x with a
    small y bob and yaw wiggle, returning to the start ``cycles`` times.
    Returns a list of float64 (4, 4) world <- camera poses."""
    Ts = []
    for k in range(n):
        ph = 2.0 * np.pi * cycles * k / max(n - 1, 1)
        tw = torch.tensor(
            [x_amp * np.sin(ph), y_amp * np.sin(0.5 * ph), 0.0, 0.0,
             yaw_amp * np.sin(0.75 * ph), 0.0],
            dtype=torch.float32,
        )
        Ts.append(se3.se3_exp(tw).numpy().astype(np.float64))
    return Ts


def render_sequence(camera, trajectory, noise=0.001):
    """Render (grays, depths) lists for a pose list (seed = frame index)."""
    grays, depths = [], []
    for i, T in enumerate(trajectory):
        g, d = render_textured_room(camera, T, noise=noise, seed=i)
        grays.append(g)
        depths.append(d)
    return grays, depths
