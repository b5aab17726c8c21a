"""Synthetic multi-person skeleton scenes.

Counterpart of the scene half of ``perception_tpu/models/pose_data.py``,
in numpy: stick-figure people placed at random from a
``numpy.random.Generator`` and rendered with a distinct colour per limb
class. ``render_people`` on the same scene arrays gives the JAX
package's image to float32 rounding. The training targets
(``make_targets``, ``make_batch``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from perception_tpu_torch.models.pose import MPI_15_PAIRS

# Canonical MPI_15 skeleton in a unit box (x right, y down).
_CANONICAL_MPI15 = np.array(
    [
        [0.50, 0.08],  # Head
        [0.50, 0.22],  # Neck
        [0.36, 0.24],  # RShoulder
        [0.30, 0.42],  # RElbow
        [0.27, 0.60],  # RWrist
        [0.64, 0.24],  # LShoulder
        [0.70, 0.42],  # LElbow
        [0.73, 0.60],  # LWrist
        [0.42, 0.55],  # RHip
        [0.40, 0.75],  # RKnee
        [0.39, 0.95],  # RAnkle
        [0.58, 0.55],  # LHip
        [0.60, 0.75],  # LKnee
        [0.61, 0.95],  # LAnkle
        [0.50, 0.38],  # Chest
    ],
    np.float32,
)

# One distinct colour per limb class, so parts are identifiable.
_LIMB_COLORS = np.array(
    [
        (0.95, 0.25, 0.25), (0.95, 0.60, 0.20), (0.90, 0.90, 0.25),
        (0.55, 0.90, 0.25), (0.25, 0.90, 0.40), (0.25, 0.90, 0.85),
        (0.25, 0.60, 0.95), (0.30, 0.30, 0.95), (0.60, 0.25, 0.95),
        (0.90, 0.25, 0.90), (0.95, 0.40, 0.60), (0.70, 0.80, 0.95),
        (0.95, 0.80, 0.60), (0.60, 0.95, 0.75),
    ],
    np.float32,
)

_F32 = np.float32


class SkeletonScene(NamedTuple):
    joints: np.ndarray   # (..., N, P, 2) xy pixel coords
    valid: np.ndarray    # (..., N) bool: person slot in use


def sample_skeletons(
    rng: np.random.Generator,
    hw: Tuple[int, int],
    n_people: int = 2,
    min_people: int = 1,
    scale_range: Tuple[float, float] = (0.45, 0.75),
    jitter: float = 0.02,
) -> SkeletonScene:
    """Random placements of the canonical skeleton: per-person scale,
    rotation, translation and per-joint jitter, kept inside the frame."""
    H, W = hw
    P = _CANONICAL_MPI15.shape[0]
    scale = rng.uniform(scale_range[0], scale_range[1], (n_people, 1, 1)).astype(np.float32) * _F32(min(H, W))
    theta = rng.uniform(-0.25, 0.25, (n_people,)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # (N, 2, 2)
    base = _CANONICAL_MPI15 - _F32(0.5)
    pts = np.einsum("nij,pj->npi", rot, base) * scale  # (N, P, 2)

    span = scale[:, 0, 0]  # ~height of the figure
    tx = rng.uniform(_F32(0.55) * span, W - _F32(0.55) * span).astype(np.float32)
    ty = rng.uniform(_F32(0.55) * span, H - _F32(0.55) * span).astype(np.float32)
    pts = pts + np.stack([tx, ty], -1)[:, None, :]
    pts = pts + rng.standard_normal((n_people, P, 2)).astype(np.float32) * _F32(jitter) * scale
    pts = np.clip(pts, _F32(2.0), np.array([W - 3.0, H - 3.0], np.float32))

    n_valid = rng.integers(min_people, n_people + 1)
    return SkeletonScene(joints=pts.astype(np.float32), valid=np.arange(n_people) < n_valid)


def stack_scenes(scenes) -> SkeletonScene:
    """A batch of scenes: joints (B, N, P, 2), valid (B, N)."""
    return SkeletonScene(np.stack([s.joints for s in scenes]), np.stack([s.valid for s in scenes]))


def _capsule_dist(px, a, b):
    """Distance from pixel grid px (H, W, 2) to segment a-b (2,)."""
    ab = b - a
    denom = np.maximum(np.dot(ab, ab), _F32(1e-8))
    t = np.clip(((px - a) * ab).sum(-1) / denom, _F32(0.0), _F32(1.0))
    proj = a + t[..., None] * ab
    return np.linalg.norm(px - proj, axis=-1)


def render_people(scene: SkeletonScene, hw: Tuple[int, int], limb_width: float = 2.5) -> np.ndarray:
    """Stick-figure RGB render of one scene: coloured capsules per limb,
    white joint dots, a dark-gray background. (H, W, 3) float32 in [0, 1]."""
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    px = np.stack([xx, yy], -1).astype(np.float32)
    fg = np.zeros((H, W, 3), np.float32)
    for joints, valid in zip(np.asarray(scene.joints, np.float32), np.asarray(scene.valid)):
        img = np.zeros((H, W, 3), np.float32)
        for l, (a, b) in enumerate(MPI_15_PAIRS):
            d = _capsule_dist(px, joints[a], joints[b])
            alpha = np.clip(_F32(1.0) - (d - _F32(limb_width)) / _F32(1.5), _F32(0.0), _F32(1.0))
            img = np.maximum(img, alpha[..., None] * _LIMB_COLORS[l])
        dj = np.linalg.norm(px[None] - joints[:, None, None, :], axis=-1)
        dots = np.clip(_F32(1.0) - (dj.min(0) - _F32(1.5)) / _F32(1.0), _F32(0.0), _F32(1.0))
        img = np.maximum(img, dots[..., None])
        fg = np.maximum(fg, img * _F32(valid))
    return np.clip(_F32(0.12) + fg, _F32(0.0), _F32(1.0))
