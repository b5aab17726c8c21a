"""A pool of D435 tabletop depth frames: a table plane and one cuboid.

The torch form of ``perception_tpu_torch/bench/scene.py``'s
``render_depth_tabletop``: a two-surface z-buffer of the table plane
``z = table_z`` and the cuboid's box in its object frame (slab method),
plus Gaussian depth noise. Frame k's cuboid twist is ``base_twist`` with
the yaw ``yaw0 + yaw_step * k``; ``yaw0`` and the noise come from the
seed, so every seed renders frames of the same sizes and kind.
``template_points`` is the cuboid template both the program and the
reference are given (``io/templates.cuboid_template``'s three faces).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.scenes.geometry import TWO_PI, camera_rays, se3_exp


def twists(scene: dict, frames: int, seed: int) -> torch.Tensor:
    """(frames, 6) float64 cuboid twists (template -> camera) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    yaw0 = float(torch.rand((), generator=g, dtype=torch.float64)) * TWO_PI
    tw = torch.tensor(scene["base_twist"], dtype=torch.float64).repeat(frames, 1)
    tw[:, 5] = yaw0 + scene["yaw_step"] * torch.arange(frames, dtype=torch.float64)
    return tw


def render(camera: dict, scene: dict, frames: int, seed: int, device) -> torch.Tensor:
    """(frames, H, W) float32 depth in metres, rendered on ``device``."""
    rays = camera_rays(camera, device)                      # (H, W, 3)
    T = se3_exp(twists(scene, frames, seed).to(device))      # (F, 4, 4)
    Rinv = T[:, :3, :3].transpose(-1, -2)
    o = -(Rinv @ T[:, :3, 3:])[..., 0]                       # camera origin, object frame
    half = torch.tensor(scene["dims"], dtype=torch.float64, device=device) / 2.0
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((frames, camera["height"], camera["width"]), dtype=torch.float32, device=device)
    for f in range(frames):
        d = rays @ Rinv[f].T                                 # ray directions, object frame
        t1 = (-half - o[f]) / d
        t2 = (half - o[f]) / d
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t_hit = torch.where(tmin > 0, tmin, tmax)
        z_box = torch.where(hit, t_hit * rays[..., 2], torch.full_like(t_hit, float("inf")))
        depth = torch.clamp(z_box, max=scene["table_z"])
        noise = torch.randn(depth.shape, generator=g, dtype=torch.float64, device=device)
        out[f] = (depth + noise * scene["noise"]).to(torch.float32)
    return out


def template_points(dims, density) -> np.ndarray:
    """The three visible faces (bottom, front, left) of a centred cuboid,
    half-open grids of ``density`` metres: float32 (N, 3)."""
    L, W, H = dims
    xs, ys, zs = (np.arange(-a / 2.0, a / 2.0, density) for a in (L, W, H))
    a, b = np.meshgrid(xs, ys)
    bottom = np.stack([a.ravel(), b.ravel(), np.full(a.size, -H / 2.0)], 1)
    a, c = np.meshgrid(xs, zs)
    front = np.stack([a.ravel(), np.full(a.size, -W / 2.0), c.ravel()], 1)
    b, c = np.meshgrid(ys, zs)
    left = np.stack([np.full(b.size, -L / 2.0), b.ravel(), c.ravel()], 1)
    return np.concatenate([bottom, front, left]).astype(np.float32)
