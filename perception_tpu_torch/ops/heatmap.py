"""Heatmap ops: multi-scale resize+merge and peak NMS with subpixel refinement.

Counterpart of ``perception_tpu/ops/heatmap.py``. Every function takes
leading batch dimensions before (C, H, W), so a batch of frames decodes
in one call.

* ``resize_and_merge``: each scale's maps resized as ``jax.image.resize``
  resizes them (``ops/resize.py``), then averaged over the scales.
* ``nms_heatmap``: a strict 3x3 local maximum above the threshold, with
  ties broken in raster order (a plateau gives one peak), the top K per
  channel, and the quadratic subpixel refinement. ``lax.top_k`` gives
  ties to the lower index; the port takes its top K by a stable
  descending sort (``features._top_k``), never ``torch.topk``, whose tie
  order on CUDA is not defined.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.features import _top_k
from perception_tpu_torch.ops.resize import resize


def resize_and_merge(heatmaps: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., S, C, h, w) per-scale maps -> (..., C, H, W): each resized to
    ``out_hw``, then averaged over the scales. (The JAX function's
    ``scale_weights`` has no caller and is not ported.)"""
    return resize(heatmaps, out_hw).mean(dim=-4)


class Peaks(NamedTuple):
    xy: torch.Tensor     # (..., C, K, 2) float32 subpixel (x, y)
    score: torch.Tensor  # (..., C, K)
    mask: torch.Tensor   # (..., C, K)


def nms_heatmap(heatmaps: torch.Tensor, threshold=0.05, max_peaks: int = 32) -> Peaks:
    """(..., C, H, W) heatmaps -> the top ``max_peaks`` peaks of each channel.

    A peak is a 3x3 local maximum above ``threshold``: strictly greater
    than its raster-earlier neighbours and >= its later ones. Its position
    is refined per axis by dx = (f(x+1) - f(x-1)) / (2 (2 f(x) - f(x-1) -
    f(x+1))), clipped to +-0.5. ``threshold`` is a float or a 0-dim tensor.
    """
    H, W = heatmaps.shape[-2:]
    lead = heatmaps.shape[:-2]
    hm = heatmaps.reshape(-1, H, W)  # channels are independent
    padded = F.pad(hm, (1, 1, 1, 1), value=float("-inf"))

    is_peak = hm > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            # The neighbour at (y - dy, x - dx), -inf outside the map.
            n = padded[..., 1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
            if dy > 0 or (dy == 0 and dx > 0):   # raster-earlier: beat it strictly
                is_peak &= hm > n
            else:
                is_peak &= hm >= n
    score = torch.where(is_peak, hm, torch.full_like(hm, -1.0))

    top, idx = _top_k(score.flatten(-2), max_peaks)  # (M, K)
    py = torch.div(idx, W, rounding_mode="floor")
    px = idx - py * W
    valid = top > 0

    flat = hm.flatten(-2)

    def gather(dy, dx):
        yy = torch.clamp(py + dy, 0, H - 1)
        xx = torch.clamp(px + dx, 0, W - 1)
        return flat.gather(-1, yy * W + xx)

    c0 = gather(0, 0)
    left, right = gather(0, -1), gather(0, 1)
    up, down = gather(-1, 0), gather(1, 0)
    denom_x = torch.clamp(2.0 * c0 - left - right, min=1e-6)
    denom_y = torch.clamp(2.0 * c0 - up - down, min=1e-6)
    off_x = torch.clamp((right - left) / (2.0 * denom_x), -0.5, 0.5)
    off_y = torch.clamp((down - up) / (2.0 * denom_y), -0.5, 0.5)

    xy = torch.stack([px + off_x, py + off_y], dim=-1)
    out_shape = lead + (max_peaks,)
    return Peaks(
        xy=torch.where(valid[..., None], xy, torch.zeros_like(xy)).reshape(out_shape + (2,)),
        score=torch.where(valid, top, torch.zeros_like(top)).reshape(out_shape),
        mask=valid.reshape(out_shape),
    )


def gaussian_heatmap(hw: Tuple[int, int], centers: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Render (K, 2) centres (x, y) into (K, H, W) Gaussian heatmaps."""
    H, W = hw
    yy = torch.arange(H, dtype=torch.float32, device=centers.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=centers.device)[None, :]
    dx = xx[None] - centers[:, 0][:, None, None]
    dy = yy[None] - centers[:, 1][:, None, None]
    return torch.exp(-(dx * dx + dy * dy) / const(2.0 * sigma * sigma, centers))
