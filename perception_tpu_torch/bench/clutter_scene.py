"""Cluttered multi-object tabletop scenes and per-class templates, numpy only.

A copy of ``benchmarks/clutter_scene.py`` that needs no JAX: its
rotations come from the port's ``so3_exp`` on the CPU. Four rigid classes
(screwdriver, eraser, clamp, marker) built from box and cylinder
primitives with local offsets, ray-cast depth, and templates captured the
way the reference captured its own: the object alone on the table, the
off-table points moved into the object frame.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.io.templates import box_surface_template, cylinder_surface_template

# kind, dims, local offset (object frame); dims: box (L, W, H), cylinder (radius, height).
OBJECT_CLASSES: Dict[str, List[Tuple[str, tuple, tuple]]] = {
    "screwdriver": [
        ("box", (0.13, 0.012, 0.012), (-0.035, 0.0, 0.0)),
        ("box", (0.07, 0.028, 0.028), (0.065, 0.0, 0.0)),
    ],
    "eraser": [("box", (0.06, 0.025, 0.012), (0.0, 0.0, 0.0))],
    "clamp": [
        ("box", (0.14, 0.03, 0.025), (0.0, 0.0, 0.0)),
        ("box", (0.03, 0.08, 0.025), (0.055, 0.05, 0.0)),
    ],
    "marker": [("cylinder", (0.009, 0.12), (0.0, 0.0, 0.0))],
}


def so3_exp(omega) -> np.ndarray:
    """Axis-angle (3,) -> float64 (3, 3), through the port's float32 ``so3_exp``."""
    return se3.so3_exp(torch.tensor(omega, dtype=torch.float32)).numpy().astype(np.float64)


def class_template(name: str, density: float = 0.002) -> np.ndarray:
    """Full-surface ICP template of a class, in its object frame."""
    parts = []
    for kind, dims, off in OBJECT_CLASSES[name]:
        if kind == "box":
            pts = box_surface_template(dims, density)
        else:
            pts = cylinder_surface_template(dims[0], dims[1], density)
        parts.append(pts + np.asarray(off, np.float32))
    return np.concatenate(parts, 0).astype(np.float32)


def canonical_object_pose(name: str, table_z: float = 0.70) -> np.ndarray:
    """The capture pose: centred on the table, no yaw (the marker on its side)."""
    R = so3_exp([0.0, np.pi / 2, 0.0]) if name == "marker" else np.eye(3)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (0.0, 0.0, table_z - 0.014)
    return T


def captured_template(name: str, camera, table_z: float = 0.70) -> np.ndarray:
    """Render the object alone on the table without noise, keep the points
    above the table and move them into the object frame: float32 (N, 3)."""
    T0 = canonical_object_pose(name, table_z)
    depth = render_depth_clutter(camera, {name: T0}, table_z=table_z, noise=0.0)
    H, W = depth.shape
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = depth.astype(np.float64)
    pts = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z], -1).reshape(-1, 3)
    pts = pts[pts[:, 2] < table_z - 0.004]
    obj = (pts - T0[:3, 3]) @ T0[:3, :3]
    return obj.astype(np.float32)


def _raycast_box(o, d, half):
    """Slab intersection in the box frame: ray parameter t (inf on a miss)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / d
        t2 = (half - o) / d
    tmin = np.minimum(t1, t2).max(-1)
    tmax = np.maximum(t1, t2).min(-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit, t, np.inf)


def _raycast_cylinder(o, d, radius, height):
    """z-axis cylinder with caps, in its frame: ray parameter t (inf on a miss)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4 * a * c
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_side1 = (-b - sq) / (2 * a)
        t_side2 = (-b + sq) / (2 * a)
    t_side = np.where(t_side1 > 0, t_side1, t_side2)
    z_at = oz + t_side * dz
    side_ok = (disc >= 0) & (t_side > 0) & (np.abs(z_at) <= height / 2)
    t_side = np.where(side_ok, t_side, np.inf)

    caps = np.full_like(t_side, np.inf)
    for zc in (-height / 2, height / 2):
        with np.errstate(divide="ignore", invalid="ignore"):
            t_cap = (zc - oz) / dz
        r2 = (ox + t_cap * dx) ** 2 + (oy + t_cap * dy) ** 2
        ok = (t_cap > 0) & (r2 <= radius * radius)
        caps = np.minimum(caps, np.where(ok, t_cap, np.inf))
    return np.minimum(t_side, caps)


def render_depth_clutter(
    camera,
    objects: Dict[str, np.ndarray],
    table_z: float = 0.70,
    noise: float = 0.0012,
    seed: int = 0,
) -> np.ndarray:
    """Ray-cast depth of a table and the {class: (4, 4) camera <- object
    pose} objects, plus Gaussian noise from ``seed``: float32 (H, W) metres."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)

    depth = np.full((H, W), table_z, np.float64)
    for name, T_obj in objects.items():
        T_obj = np.asarray(T_obj, np.float64)
        for kind, dims, off in OBJECT_CLASSES[name]:
            T_local = np.eye(4)
            T_local[:3, 3] = off
            T = T_obj @ T_local
            Rinv = T[:3, :3].T
            o = Rinv @ (-T[:3, 3])
            d = rays @ Rinv.T
            if kind == "box":
                t = _raycast_box(o, d, np.asarray(dims, np.float64) / 2.0)
            else:
                t = _raycast_cylinder(o, d, dims[0], dims[1])
            z = np.where(np.isfinite(t), t * rays[..., 2], np.inf)
            depth = np.minimum(depth, z)

    rng = np.random.RandomState(seed)
    depth = depth + rng.randn(H, W) * noise
    return depth.astype(np.float32)


def standard_clutter_poses(table_z: float = 0.70) -> Dict[str, np.ndarray]:
    """The 4-object tabletop arrangement: each object flat on the table,
    more than the 2 cm cluster tolerance apart, each with its own yaw."""
    placements = {
        "screwdriver": (-0.13, -0.08, 0.35),
        "eraser": (0.11, -0.08, -0.5),
        "clamp": (0.11, 0.09, 1.2),
        "marker": (-0.11, 0.10, 0.0),
    }
    poses = {}
    for name, (x, y, yaw) in placements.items():
        R_lay = so3_exp([0.0, np.pi / 2, 0.0]) if name == "marker" else np.eye(3)
        T = np.eye(4)
        T[:3, :3] = so3_exp([0.0, 0.0, yaw]) @ R_lay
        T[:3, 3] = (x, y, table_z - 0.014)
        poses[name] = T
    return poses
