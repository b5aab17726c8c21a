"""Multi-cuboid bag-replay scenes for the streaming tracker, numpy only.

A copy of ``benchmarks/tracking_scene.py`` that needs no JAX: poses come
from the port's ``se3_exp``/``so3_exp`` on the CPU. A table with three
cuboids of distinct sizes under a moving camera; the world-frame object
poses are constant, so each frame's camera-frame pose is exact ground
truth.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from perception_tpu_torch.bench.clutter_scene import _raycast_box, so3_exp
from perception_tpu_torch.geometry import se3

# (dims, (x, y, z, yaw)) per cuboid; the translation is applied literally.
CUBOID_SET: List[Tuple[Tuple[float, float, float], Tuple[float, ...]]] = [
    ((0.20, 0.10, 0.03), (-0.16, 0.04, 0.80, 0.30)),
    ((0.12, 0.08, 0.05), (0.17, 0.00, 0.82, -0.60)),
    ((0.09, 0.06, 0.04), (0.00, -0.17, 0.78, 1.10)),
]


def camera_trajectory(n: int, amp: float = 0.08, yaw_amp: float = 0.06):
    """Smooth world <- camera sweep (a small orbit around the table):
    a list of float64 (4, 4)."""
    Ts = []
    for k in range(n):
        ph = 2.0 * np.pi * k / max(n - 1, 1)
        tw = torch.tensor(
            [amp * np.sin(ph), 0.5 * amp * np.sin(2 * ph), 0.02 * np.sin(ph),
             0.0, yaw_amp * np.sin(ph), 0.02 * np.cos(ph)],
            dtype=torch.float32,
        )
        Ts.append(se3.se3_exp(tw).numpy().astype(np.float64))
    return Ts


def object_world_poses(cuboids=CUBOID_SET):
    poses = []
    for _, (x, y, z, yaw) in cuboids:
        T = np.eye(4)
        T[:3, :3] = so3_exp([0.0, 0.0, yaw])
        T[:3, 3] = (x, y, z)
        poses.append(T)
    return poses


def render_depth_cuboids(
    camera,
    T_wc: np.ndarray,
    cuboids=CUBOID_SET,
    table_z: float = 0.85,
    noise: float = 0.0015,
    seed: int = 0,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(depth float32 (H, W), [camera-frame ground-truth pose per cuboid])."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)

    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    # The table plane z_world = table_z in the camera frame.
    n_w = np.array([0.0, 0.0, 1.0])
    n_c = T_cw[:3, :3] @ n_w
    d0 = table_z - n_w @ T_wc[:3, 3]
    denom = rays @ n_c
    with np.errstate(divide="ignore", invalid="ignore"):
        t = d0 / denom
    depth = np.where((t > 0.05) & (denom != 0), t * rays[..., 2], np.inf)

    gt_poses = []
    for (dims, _), T_wo in zip(cuboids, object_world_poses(cuboids)):
        T_co = T_cw @ T_wo
        gt_poses.append(T_co)
        Rinv = T_co[:3, :3].T
        o = Rinv @ (-T_co[:3, 3])
        d = rays @ Rinv.T
        t = _raycast_box(o, d, np.asarray(dims, np.float64) / 2.0)
        z = np.where(np.isfinite(t), t * rays[..., 2], np.inf)
        depth = np.minimum(depth, z)

    depth[~np.isfinite(depth)] = 0.0
    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32), gt_poses
