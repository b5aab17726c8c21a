"""Synthetic multi-person skeleton scenes.

Counterpart of ``perception_tpu/models/pose_data.py``: stick-figure
people placed at random from a ``numpy.random.Generator`` (numpy) and
rendered in torch with a distinct colour per limb class:
``render_people_batch`` renders a batch of scenes on the caller's
device, ``render_people`` one scene on the CPU, in numpy in and out. On
the same scene arrays they give the JAX package's image to float32
rounding.

The training half, in torch on the caller's device: ``make_targets``
(the CMU two-branch targets, channel-first) and ``make_batch``. The
draws come from a ``numpy.random.Generator`` (``draw_batch``) and can be
given instead (``draws=``), so a batch can be made from the JAX
package's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch.models._render import gaussian_maps, pixel_grid, point_distance, segment_distance
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


# --- renders and training batches (torch, on the caller's device) ---------

def render_people_batch(joints: torch.Tensor, valid: torch.Tensor, hw: Tuple[int, int],
                        limb_width: float = 2.5) -> torch.Tensor:
    """Stick-figure RGB renders of a batch on ``joints``' device: coloured
    capsules per limb, white joint dots, a dark-gray background; joints
    (B, N, P, 2), valid (B, N) -> (B, H, W, 3) float32 in [0, 1]."""
    X, Y = pixel_grid(hw, joints.device)
    img = None
    for l, (a, b) in enumerate(MPI_15_PAIRS):
        d = segment_distance(X, Y, joints[..., a, :], joints[..., b, :])  # (B, N, H, W)
        alpha = torch.clamp(1.0 - (d - limb_width) / 1.5, 0.0, 1.0)
        layer = torch.stack([alpha * float(c) for c in _LIMB_COLORS[l]], -1)
        img = layer if img is None else torch.maximum(img, layer)
    dj = point_distance(X, Y, joints).amin(-3)  # (B, N, H, W)
    dots = torch.clamp(1.0 - (dj - 1.5) / 1.0, 0.0, 1.0)
    img = torch.maximum(img, dots[..., None]) * valid[..., None, None, None].to(torch.float32)
    return torch.clamp(0.12 + img.amax(1), 0.0, 1.0)


def render_people(scene: SkeletonScene, hw: Tuple[int, int], limb_width: float = 2.5) -> np.ndarray:
    """``render_people_batch`` of one scene (joints (N, P, 2), valid (N,))
    on the CPU: (H, W, 3) float32 in [0, 1]."""
    joints = torch.from_numpy(np.asarray(scene.joints, np.float32))[None]
    valid = torch.from_numpy(np.asarray(scene.valid, bool))[None]
    return render_people_batch(joints, valid, hw, limb_width)[0].numpy()


def make_targets(joints: torch.Tensor, valid: torch.Tensor, map_hw: Tuple[int, int], stride: int = 8,
                 sigma: float = 1.2, paf_width: float = 0.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """CMU two-branch training targets at map resolution, on ``joints``'
    device, for (..., N, P, 2) joints and (..., N) valid people of the
    MPI_15 skeleton.

    Returns (paf (..., 2L, h, w), heatmap (..., P+1, h, w)), channel-first
    (channel 2l + c is limb l's x / y): part heatmaps are the
    max-over-people Gaussian, PAFs the averaged unit limb direction inside
    each limb capsule, background = 1 - max(parts)."""
    X, Y = pixel_grid(map_hw, joints.device)
    jm = joints / float(stride)
    g = gaussian_maps(X, Y, jm, sigma) * valid[..., None, None, None].to(torch.float32)  # (..., N, P, h, w)
    hm = g.amax(-4)
    background = torch.clamp(1.0 - hm.amax(-3), 0.0, 1.0)
    heatmap = torch.cat([hm, background[..., None, :, :]], -3)

    pafs = []
    for a, b in MPI_15_PAIRS:
        ja, jb = jm[..., a, :], jm[..., b, :]  # (..., N, 2)
        inside = (segment_distance(X, Y, ja, jb) < paf_width) & valid[..., None, None]  # (..., N, h, w)
        u = (jb - ja) / torch.clamp(torch.linalg.vector_norm(jb - ja, dim=-1, keepdim=True), min=1e-6)
        vec = inside[..., None, :, :].to(torch.float32) * u[..., None, None]  # (..., N, 2, h, w)
        cnt = torch.clamp(inside.sum(-3), min=1)[..., None, :, :]
        pafs.append(vec.sum(-4) / cnt)  # (..., 2, h, w)
    return torch.cat(pafs, -3), heatmap


class PoseDraws(NamedTuple):
    """The random draws of a ``make_batch`` batch."""
    scene: SkeletonScene            # joints (B, N, P, 2), valid (B, N)
    level: Optional[np.ndarray]     # (B,) uniform [0, 1): the noise level over pixel_noise
    noise: Optional[np.ndarray]     # (B, H, W, 3) standard normal


def draw_batch(generator: np.random.Generator, batch: int, hw: Tuple[int, int], n_people: int = 2,
               pixel_noise: float = 0.0) -> PoseDraws:
    """``batch`` skeleton scenes, then (with ``pixel_noise``) the noise draws."""
    scene = stack_scenes([sample_skeletons(generator, hw, n_people) for _ in range(batch)])
    if pixel_noise <= 0.0:
        return PoseDraws(scene, None, None)
    level = generator.random(batch, dtype=np.float32)
    return PoseDraws(scene, level, generator.standard_normal((batch, *hw, 3), dtype=np.float32))


def make_batch(generator: Optional[np.random.Generator], batch: int, hw: Tuple[int, int], n_people: int = 2,
               stride: int = 8, pixel_noise: float = 0.0, device="cuda", draws: Optional[PoseDraws] = None) -> dict:
    """One training batch on ``device``: images (B, 3, H, W) in [0, 1],
    their targets ("paf" (B, 2L, h, w), "heatmap" (B, P+1, h, w)) and the
    scenes (numpy). ``pixel_noise`` > 0 adds per-scene Gaussian noise at a
    random level in [0, pixel_noise] of full scale (the robustness
    augmentation of the held-out noise families). The draws come from
    ``generator`` unless ``draws`` gives them."""
    if draws is None:
        draws = draw_batch(generator, batch, hw, n_people, pixel_noise)
    joints = torch.from_numpy(np.array(draws.scene.joints, np.float32)).to(device)
    valid = torch.from_numpy(np.array(draws.scene.valid, bool)).to(device)
    images = render_people_batch(joints, valid, hw)
    if pixel_noise > 0.0:
        lvl = torch.from_numpy(np.array(draws.level, np.float32)).to(device)[:, None, None, None] * pixel_noise
        noise = torch.from_numpy(np.array(draws.noise, np.float32)).to(device)
        images = torch.clamp(images + noise * lvl, 0.0, 1.0)
    paf, heatmap = make_targets(joints, valid, (hw[0] // stride, hw[1] // stride), stride)
    return {"image": images.permute(0, 3, 1, 2).contiguous(), "paf": paf, "heatmap": heatmap, "scene": draws.scene}
