"""Synthetic hand scenes for the hand fixture.

Counterpart of ``perception_tpu/models/hand_data.py`` in numpy: a
canonical 21-landmark hand (wrist + 4 joints a finger), placed, rotated
and flexed at random from a ``numpy.random.Generator``, and rendered as
capsule strokes with a distinct intensity per finger. ``render_hand`` on
the same scene arrays gives the JAX package's image to float32 rounding.
The training batch (``make_hand_batch``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

# Canonical 21-point hand in a unit box (x right, y down), palm down,
# fingers up: 0 wrist; 1-4 thumb; 5-8 index; 9-12 middle; 13-16 ring;
# 17-20 pinky (the OpenPose/MediaPipe ordering).
CANONICAL_HAND = np.array(
    [
        (0.50, 0.92),
        (0.38, 0.82), (0.28, 0.72), (0.21, 0.64), (0.16, 0.57),   # thumb
        (0.40, 0.60), (0.38, 0.46), (0.37, 0.35), (0.36, 0.26),   # index
        (0.50, 0.58), (0.50, 0.42), (0.50, 0.30), (0.50, 0.20),   # middle
        (0.60, 0.60), (0.62, 0.45), (0.63, 0.34), (0.64, 0.26),   # ring
        (0.69, 0.64), (0.72, 0.52), (0.74, 0.44), (0.75, 0.37),   # pinky
    ],
    np.float32,
)

FINGER_CHAINS = [
    [0, 1, 2, 3, 4],
    [0, 5, 6, 7, 8],
    [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16],
    [0, 17, 18, 19, 20],
]
# Distinct stroke intensity per finger, so landmarks are identifiable.
FINGER_LEVELS = np.array([0.95, 0.78, 0.62, 0.47, 0.33], np.float32)

_F32 = np.float32


class HandScene(NamedTuple):
    joints: np.ndarray   # (21, 2) pixel coords
    scale: np.ndarray    # () hand size in px


def sample_hand(
    rng: np.random.Generator,
    hw: Tuple[int, int],
    scale_range: Tuple[float, float] = (0.45, 0.8),
    flex: float = 0.03,
) -> HandScene:
    """A random hand: size, rotation, position inside the frame, and
    per-joint flex."""
    H, W = hw
    s = _F32(rng.uniform(scale_range[0], scale_range[1]) * min(H, W))
    th = _F32(rng.uniform(-np.pi, np.pi))
    c, sn = np.cos(th), np.sin(th)
    R = np.array([[c, -sn], [sn, c]], np.float32)
    base = CANONICAL_HAND - _F32(0.5)
    pts = base @ R.T * s
    span = _F32(0.55) * s
    lo, hi = np.array([span, span], np.float32), np.array([W, H], np.float32) - span
    pts = pts + rng.uniform(lo, hi).astype(np.float32)
    pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * _F32(flex) * s
    pts = np.clip(pts, _F32(2.0), np.array([W - 3.0, H - 3.0], np.float32))
    return HandScene(joints=pts.astype(np.float32), scale=s)


def _seg_dist(px, a, b):
    """Distance from pixel grid px (H, W, 2) to segment a-b (2,)."""
    ab = b - a
    denom = np.maximum(np.dot(ab, ab), _F32(1e-8))
    t = np.clip(((px - a) * ab).sum(-1) / denom, _F32(0.0), _F32(1.0))
    proj = a + t[..., None] * ab
    return np.linalg.norm(px - proj, axis=-1)


def render_hand(scene: HandScene, hw: Tuple[int, int], rng: np.random.Generator = None) -> np.ndarray:
    """(H, W) float32 grayscale in [0, 255]; with ``rng``, plus Gaussian
    noise of standard deviation 2 drawn from it."""
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    px = np.stack([xx, yy], -1).astype(np.float32)
    joints = np.asarray(scene.joints, np.float32)
    stroke = np.clip(_F32(scene.scale) * _F32(0.035), _F32(1.2), _F32(5.0))

    img = np.full((H, W), 0.1, np.float32)
    for chain, level in zip(FINGER_CHAINS, FINGER_LEVELS):
        d = np.full((H, W), 1e9, np.float32)
        for i in range(len(chain) - 1):
            d = np.minimum(d, _seg_dist(px, joints[chain[i]], joints[chain[i + 1]]))
        alpha = np.clip(_F32(1.0) - (d - stroke) / _F32(1.5), _F32(0.0), _F32(1.0))
        img = np.maximum(img, alpha * level)
    # Joint dots (bright) so exact joint positions are marked.
    dj = np.linalg.norm(px[None] - joints[:, None, None, :], axis=-1)
    dots = np.clip(_F32(1.0) - (dj.min(0) - _F32(1.2)) / _F32(1.0), _F32(0.0), _F32(1.0))
    img = np.maximum(img, dots) * _F32(255.0)
    if rng is not None:
        img = img + rng.standard_normal((H, W)).astype(np.float32) * _F32(2.0)
    return np.clip(img, _F32(0.0), _F32(255.0))


def hand_box(joints: np.ndarray, margin: float = 1.3) -> np.ndarray:
    """A square box around (..., 21, 2) joints, ``margin`` times their span."""
    joints = np.asarray(joints, np.float32)
    lo = joints.min(axis=-2)
    hi = joints.max(axis=-2)
    c = _F32(0.5) * (lo + hi)
    half = _F32(0.5) * (hi - lo).max(axis=-1, keepdims=True) * _F32(margin)
    return np.concatenate([c - half, c + half], axis=-1)
