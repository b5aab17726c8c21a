"""Template generation, numpy only.

A copy of ``perception_tpu/io/templates.py``'s ``cuboid_template``,
``box_surface_template``, ``cylinder_surface_template`` and
``cuboid_vertices``: the JAX package cannot be imported where the port
runs (its ``__init__`` imports jax).
"""

from __future__ import annotations

import numpy as np


def cuboid_template(
    length: float = 0.2,
    width: float = 0.1,
    height: float = 0.075,
    density: float = 0.002,
) -> np.ndarray:
    """Sample the 3 visible faces of a centered cuboid -> float32 (N, 3).

    Half-open grids ``arange(-D/2, D/2, density)`` per axis; face order
    bottom (z=-H/2), front (y=-W/2), left (x=-L/2).
    """
    xs = np.arange(-length / 2.0, length / 2.0, density)
    ys = np.arange(-width / 2.0, width / 2.0, density)
    zs = np.arange(-height / 2.0, height / 2.0, density)

    def face(a_vals, b_vals):
        a, b = np.meshgrid(a_vals, b_vals)
        return a.ravel(), b.ravel()

    fx, fy = face(xs, ys)
    bottom = np.stack([fx, fy, np.full_like(fx, -height / 2.0)], axis=1)
    fx, fz = face(xs, zs)
    front = np.stack([fx, np.full_like(fx, -width / 2.0), fz], axis=1)
    fy, fz = face(ys, zs)
    left = np.stack([np.full_like(fy, -length / 2.0), fy, fz], axis=1)

    return np.concatenate([bottom, front, left], axis=0).astype(np.float32)


def box_surface_template(dims, density: float = 0.002) -> np.ndarray:
    """Sample all 6 faces of a centered L x W x H box -> float32 (N, 3);
    faces in the order z = -+H/2, y = -+W/2, x = -+L/2."""
    L, W, H = dims
    xs = np.arange(-L / 2.0, L / 2.0, density)
    ys = np.arange(-W / 2.0, W / 2.0, density)
    zs = np.arange(-H / 2.0, H / 2.0, density)
    faces = []
    for vals_a, vals_b, axis, half in [
        (xs, ys, 2, H / 2.0),
        (xs, zs, 1, W / 2.0),
        (ys, zs, 0, L / 2.0),
    ]:
        a, b = np.meshgrid(vals_a, vals_b)
        flat = np.stack([a.ravel(), b.ravel()], 1)
        for sign in (-1.0, 1.0):
            faces.append(np.insert(flat, axis, sign * half, axis=1))
    return np.concatenate(faces, 0).astype(np.float32)


def cylinder_surface_template(radius: float, height: float, density: float = 0.002) -> np.ndarray:
    """Sample the side and both caps of a z-axis-centered cylinder -> (N, 3)."""
    n_theta = max(8, int(round(2 * np.pi * radius / density)))
    thetas = np.linspace(0.0, 2 * np.pi, n_theta, endpoint=False)
    zs = np.arange(-height / 2.0, height / 2.0, density)
    tt, zz = np.meshgrid(thetas, zs)
    side = np.stack([radius * np.cos(tt).ravel(), radius * np.sin(tt).ravel(), zz.ravel()], 1)
    caps = []
    for r in np.arange(density, radius, density):
        n = max(6, int(round(2 * np.pi * r / density)))
        th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        ring = np.stack([r * np.cos(th), r * np.sin(th)], 1)
        for sign in (-1.0, 1.0):
            caps.append(np.concatenate([ring, np.full((len(ring), 1), sign * height / 2.0)], 1))
    return np.concatenate([side] + caps, 0).astype(np.float32)


def cuboid_vertices(length: float, width: float, height: float) -> np.ndarray:
    """The 8 corners of a centered L x W x H cuboid, float32 (8, 3)."""
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float32,
    )
    return signs * np.array([length / 2.0, width / 2.0, height / 2.0], dtype=np.float32)
