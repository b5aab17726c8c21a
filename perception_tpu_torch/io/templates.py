"""Cuboid template generation, numpy only.

A copy of ``perception_tpu/io/templates.py``'s ``cuboid_template`` and
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


def cuboid_vertices(length: float, width: float, height: float) -> np.ndarray:
    """The 8 corners of a centered L x W x H cuboid, float32 (8, 3)."""
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float32,
    )
    return signs * np.array([length / 2.0, width / 2.0, height / 2.0], dtype=np.float32)
