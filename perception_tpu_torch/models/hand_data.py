"""Synthetic hand scenes for the hand fixture.

Counterpart of ``perception_tpu/models/hand_data.py``: a canonical
21-landmark hand (wrist + 4 joints a finger), placed, rotated and flexed
at random from a ``numpy.random.Generator`` (numpy), and rendered in
torch as capsule strokes with a distinct intensity per finger:
``render_hands`` renders a batch of scenes on the caller's device,
``render_hand`` one scene on the CPU, in numpy in and out. On the same
scene arrays they give the JAX package's image to float32 rounding.

The training batch, in torch on the caller's device: ``make_hand_batch``
(renders, jittered ground-truth boxes, crops and crop-space heatmap
targets). Its draws come from a ``numpy.random.Generator``
(``draw_hand_batch``) or are given (``draws=``), so a batch can be made
from the JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch.models._render import crop_heatmaps, jittered_boxes, pixel_grid, point_distance, segment_distance

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


def hand_box(joints: np.ndarray, margin: float = 1.3) -> np.ndarray:
    """A square box around (..., 21, 2) joints, ``margin`` times their span."""
    joints = np.asarray(joints, np.float32)
    lo = joints.min(axis=-2)
    hi = joints.max(axis=-2)
    c = _F32(0.5) * (lo + hi)
    half = _F32(0.5) * (hi - lo).max(axis=-1, keepdims=True) * _F32(margin)
    return np.concatenate([c - half, c + half], axis=-1)


# --- renders and training batches (torch, on the caller's device) ---------

def render_hands(joints: torch.Tensor, scale: torch.Tensor, hw: Tuple[int, int],
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A batch of hands on ``joints``' device, each finger a capsule stroke
    at its own intensity with bright joint dots, plus Gaussian noise of
    standard deviation 2: joints (B, 21, 2), scale (B,) hand sizes in px,
    noise (B, H, W) standard normal or None -> (B, H, W) in [0, 255]."""
    X, Y = pixel_grid(hw, joints.device)
    stroke = torch.clamp(scale * 0.035, 1.2, 5.0)[:, None, None]
    img = torch.full((joints.shape[0], *hw), 0.1, device=joints.device)
    for chain, level in zip(FINGER_CHAINS, FINGER_LEVELS):
        d = None
        for i in range(len(chain) - 1):
            di = segment_distance(X, Y, joints[:, chain[i]], joints[:, chain[i + 1]])
            d = di if d is None else torch.minimum(d, di)
        alpha = torch.clamp(1.0 - (d - stroke) / 1.5, 0.0, 1.0)
        img = torch.maximum(img, alpha * float(level))
    dj = point_distance(X, Y, joints).amin(1)
    dots = torch.clamp(1.0 - (dj - 1.2) / 1.0, 0.0, 1.0)
    img = torch.maximum(img, dots) * 255.0
    if noise is not None:
        img = img + noise * 2.0
    return torch.clamp(img, 0.0, 255.0)


def render_hand(scene: HandScene, hw: Tuple[int, int], rng: np.random.Generator = None) -> np.ndarray:
    """``render_hands`` of one scene on the CPU: (H, W) float32 grayscale in
    [0, 255]; with ``rng``, plus Gaussian noise of standard deviation 2
    drawn from it."""
    noise = None if rng is None else torch.from_numpy(rng.standard_normal(hw).astype(np.float32))[None]
    joints = torch.from_numpy(np.asarray(scene.joints, np.float32))[None]
    return render_hands(joints, torch.tensor([float(scene.scale)]), hw, noise)[0].numpy()


class HandDraws(NamedTuple):
    """The random draws of a ``make_hand_batch`` batch."""
    joints: np.ndarray              # (B, 21, 2)
    scale: np.ndarray               # (B,)
    noise: np.ndarray               # (B, H, W) standard normal: the render noise
    jitter: np.ndarray              # (B, 3) uniform [-1, 1): the box augmentation
    level: Optional[np.ndarray]     # (B,) uniform [0, 1): the pixel-noise level over pixel_noise
    pixel: Optional[np.ndarray]     # (B, H, W) standard normal: the pixel noise


def draw_hand_batch(generator: np.random.Generator, batch: int, hw: Tuple[int, int] = (96, 96),
                    pixel_noise: float = 0.0) -> HandDraws:
    scenes = [sample_hand(generator, hw) for _ in range(batch)]
    joints = np.stack([s.joints for s in scenes])
    scale = np.array([s.scale for s in scenes], np.float32)
    noise = generator.standard_normal((batch, *hw), dtype=np.float32)
    jitter = generator.uniform(-1.0, 1.0, (batch, 3)).astype(np.float32)
    level = pixel = None
    if pixel_noise > 0.0:
        level = generator.random(batch, dtype=np.float32)
        pixel = generator.standard_normal((batch, *hw), dtype=np.float32)
    return HandDraws(joints, scale, noise, jitter, level, pixel)


def make_hand_batch(generator: Optional[np.random.Generator], batch: int, hw: Tuple[int, int] = (96, 96),
                    crop: int = 64, pixel_noise: float = 0.0, device="cuda",
                    draws: Optional[HandDraws] = None) -> dict:
    """A training batch on ``device``: "image" (B, H, W) renders in [0, 255],
    "crop" (B, 1, crop, crop) in [0, 1] through the jittered true box,
    "heatmaps" (B, 21, crop/4, crop/4) targets, "uv_crop" (B, 21, 2) and
    "scene" (numpy joints and scales). ``pixel_noise`` adds per-scene
    Gaussian noise at a random level in [0, pixel_noise] of 255 (the
    robustness augmentation of the held-out noise families). The draws
    come from ``generator`` unless ``draws`` gives them."""
    from perception_tpu_torch.models.hand import crop_images

    if draws is None:
        draws = draw_hand_batch(generator, batch, hw, pixel_noise)
    T = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    joints = T(draws.joints)
    img = render_hands(joints, T(draws.scale), hw, T(draws.noise))
    if pixel_noise > 0.0:
        lvl = T(draws.level)[:, None, None] * pixel_noise
        img = torch.clamp(img + T(draws.pixel) * lvl * 255.0, 0.0, 255.0)
    box = jittered_boxes(T(hand_box(draws.joints)), T(draws.jitter))
    patch = crop_images(img, box, crop)
    sx = torch.full_like(box[:, 0], float(crop)) / (box[:, 2] - box[:, 0])
    uv_crop = (joints - box[:, None, :2]) * sx[:, None, None]
    maps = crop_heatmaps(uv_crop, (crop // 4, crop // 4))
    return {"image": img, "crop": (patch / 255.0)[:, None], "heatmaps": maps, "uv_crop": uv_crop,
            "scene": HandScene(np.asarray(draws.joints, np.float32), np.asarray(draws.scale, np.float32))}
