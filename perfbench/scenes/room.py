"""A live camera's depth stream: the periodic revisit sweep of a 5-plane room.

The torch form of ``perception_tpu_torch/bench/slam_scene.py``'s
``sweep_trajectory`` and the depth half of ``render_textured_room``: the
camera oscillates along x with a small y bob and yaw wiggle and comes
back to its start ``cycles`` times over ``frames`` poses; the last pose
equals the first, so a stream that plays the first ``frames - 1`` poses
in a loop never jumps. Depth is an analytic ray-plane cast (0 where no
plane is hit) plus Gaussian noise from the seed.
"""

from __future__ import annotations

import math

import torch

from perfbench.scenes.geometry import camera_rays, se3_exp


def trajectory(scene: dict, device) -> torch.Tensor:
    """(frames, 4, 4) float64 world <- camera poses of the sweep."""
    n = scene["frames"]
    k = torch.arange(n, dtype=torch.float64, device=device)
    ph = 2.0 * math.pi * scene["cycles"] * k / max(n - 1, 1)
    z = torch.zeros_like(ph)
    tw = torch.stack([scene["x_amp"] * torch.sin(ph), scene["y_amp"] * torch.sin(0.5 * ph), z, z,
                      scene["yaw_amp"] * torch.sin(0.75 * ph), z], dim=-1)
    return se3_exp(tw)


def render(camera: dict, scene: dict, seed: int, device) -> torch.Tensor:
    """(frames - 1, H, W) float32 depth of one period of the sweep."""
    rays = camera_rays(camera, device)
    poses = trajectory(scene, device)[: scene["frames"] - 1]
    planes = [(torch.tensor(n, dtype=torch.float64, device=device), c) for n, c in scene["planes"]]
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((poses.shape[0], camera["height"], camera["width"]), dtype=torch.float32,
                      device=device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=device)
    for f, T in enumerate(poses):
        o, d = T[:3, 3], rays @ T[:3, :3].T
        depth = torch.full(rays.shape[:2], float("inf"), dtype=torch.float64, device=device)
        for n, c in planes:
            denom = d @ n
            t = (c - o @ n) / denom
            t = torch.where((t > 0.1) & (denom != 0), t, inf)
            depth = torch.minimum(depth, t * rays[..., 2])
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        noise = torch.randn(depth.shape, generator=g, dtype=torch.float64, device=device)
        out[f] = (depth + noise * scene["noise"]).to(torch.float32)
    return out
