"""Synthetic D435 tabletop scenes for the cuboid pipeline, numpy only.

A copy of ``benchmarks/scene.py``'s ``render_depth_tabletop`` and
``benchmark_template`` that needs no JAX: the cuboid pose comes from the
port's ``se3_exp`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.io.templates import cuboid_template


def render_depth_tabletop(
    camera: PinholeCamera,
    cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.35),
    dims=(0.2, 0.1, 0.03),
    table_z: float = 0.85,
    noise: float = 0.0015,
    seed: int = 0,
) -> np.ndarray:
    """Ray-cast a depth image of a table plane + one cuboid.

    Two-surface z-buffer: the table plane z = table_z and the cuboid's
    box in its object frame (slab method), plus Gaussian depth noise
    from ``seed``. Returns float32 (H, W) meters.
    """
    H, W = camera.height, camera.width
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)

    depth = np.full((H, W), table_z, np.float64)

    T = gt_pose(cuboid_pose_twist).astype(np.float64)
    Rinv = T[:3, :3].T
    o = -Rinv @ T[:3, 3]  # camera origin in the object frame
    d = rays @ Rinv.T  # ray directions in the object frame
    half = np.asarray(dims, np.float64) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / d
        t2 = (half - o) / d
    tmin = np.minimum(t1, t2).max(-1)
    tmax = np.maximum(t1, t2).min(-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t_hit = np.where(tmin > 0, tmin, tmax)
    z_box = np.where(hit, t_hit * rays[..., 2], np.inf)
    depth = np.minimum(depth, z_box)

    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32)


def gt_pose(cuboid_pose_twist) -> np.ndarray:
    """The cuboid's template -> camera pose, float32 (4, 4)."""
    return se3.se3_exp(torch.tensor(cuboid_pose_twist, dtype=torch.float32)).numpy()


def benchmark_template(dims=(0.2, 0.1, 0.03), density=0.004):
    return cuboid_template(*dims, density=density)


def bench_twist(seed: int):
    """The cuboid twist of bench frame ``seed`` (yaw 0.3 + 0.05 * seed)."""
    return (0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * seed)


def bench_frames(camera: PinholeCamera, seeds=range(8)):
    """The bench frames: (depths (S, H, W) float32, gt poses (S, 4, 4))."""
    depths = [render_depth_tabletop(camera, bench_twist(s), seed=s) for s in seeds]
    poses = [gt_pose(bench_twist(s)) for s in seeds]
    return np.stack(depths), np.stack(poses)
