"""Pixel-grid helpers of the training batches (``*_data.py``), in torch on
the caller's device: distances to points and segments for the renders,
Gaussian target maps, and the jittered crop boxes.

The coordinates are kept as separate x and y planes, so every operation
runs over (..., H, W) without a trailing axis of 2; each sum over x and y
adds x first, as the JAX package's ``(... ).sum(-1)`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_grid(hw: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, Y), each (H, W) float32: the pixel coordinates."""
    yy, xx = torch.meshgrid(torch.arange(hw[0], device=device), torch.arange(hw[1], device=device), indexing="ij")
    return xx.to(torch.float32), yy.to(torch.float32)


def _plane(v: torch.Tensor, i: int) -> torch.Tensor:
    return v[..., i, None, None]


def point_distance(X, Y, p: torch.Tensor) -> torch.Tensor:
    """Distance from each pixel to points p (..., 2): (..., H, W)."""
    dx, dy = X - _plane(p, 0), Y - _plane(p, 1)
    return torch.sqrt(dx * dx + dy * dy)


def segment_distance(X, Y, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance from each pixel to segments a-b (..., 2): (..., H, W)."""
    ax, ay = _plane(a, 0), _plane(a, 1)
    abx, aby = _plane(b, 0) - ax, _plane(b, 1) - ay
    denom = torch.clamp(abx * abx + aby * aby, min=1e-8)
    t = torch.clamp(((X - ax) * abx + (Y - ay) * aby) / denom, 0.0, 1.0)
    dx, dy = X - (ax + t * abx), Y - (ay + t * aby)
    return torch.sqrt(dx * dx + dy * dy)


def gaussian_maps(X, Y, centres: torch.Tensor, sigma: float) -> torch.Tensor:
    """exp(-|px - c|^2 / (2 sigma^2)) for centres (..., 2): (..., H, W)."""
    dx, dy = X - _plane(centres, 0), Y - _plane(centres, 1)
    return torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))


def crop_heatmaps(uv: torch.Tensor, map_hw: Tuple[int, int], stride: int = 4, sigma: float = 1.0) -> torch.Tensor:
    """(..., C, h, w) Gaussian targets of (..., C, 2) crop-space pixels on a
    map at ``stride`` (cell centres at (x + 0.5) * stride)."""
    X, Y = pixel_grid(map_hw, uv.device)
    return gaussian_maps(X, Y, uv / float(stride) - 0.5, sigma)


def jittered_boxes(box: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Square (..., 4) boxes scaled by 1 + 0.15 j0 and moved by (j1, j2) x
    0.10 of the half side, ``jitter`` (..., 3) in [-1, 1]: the box
    augmentation (at inference the crop comes from a detector or the
    body keypoints, not the true landmarks)."""
    half = 0.5 * (box[..., 2] - box[..., 0])
    c = 0.5 * (box[..., :2] + box[..., 2:])
    half = (half * (1.0 + 0.15 * jitter[..., 0]))[..., None]
    c = c + jitter[..., 1:] * 0.10 * half
    return torch.cat([c - half, c + half], -1)
