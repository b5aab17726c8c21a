"""Keypoint array utilities.

Counterpart of ``perception_tpu/utils/keypoints.py``: scale, area and
distance helpers and the ``KeepTopNPeople`` stage over fixed-capacity
``(P, K, 3)`` keypoint arrays with ``(P,)`` person masks. Invalid people
stay in place, masked out. ``[..., 0:2]`` is (u, v) in pixels,
``[..., 2]`` the confidence (0 = missing part).
"""

from __future__ import annotations

from typing import Tuple

import torch


def rescale_keypoints(keypoints: torch.Tensor, scale) -> torch.Tensor:
    """Scale (u, v) by ``scale`` (scalar or (2,)), leaving the confidence."""
    s = torch.as_tensor(scale, dtype=keypoints.dtype).to(keypoints.device, non_blocking=True)
    uv = keypoints[..., :2] * torch.broadcast_to(s, (2,))
    return torch.cat([uv, keypoints[..., 2:3]], dim=-1)


def keypoint_area(keypoints: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bounding-rectangle area per person over parts with conf > threshold.
    (P, K, 3) -> (P,); people with < 2 visible parts get 0."""
    vis = keypoints[..., 2] > threshold
    big = torch.finfo(keypoints.dtype).max
    u, v = keypoints[..., 0], keypoints[..., 1]
    umin = torch.where(vis, u, big).amin(dim=-1)
    vmin = torch.where(vis, v, big).amin(dim=-1)
    umax = torch.where(vis, u, -big).amax(dim=-1)
    vmax = torch.where(vis, v, -big).amax(dim=-1)
    area = (umax - umin) * (vmax - vmin)
    return torch.where(vis.sum(dim=-1) >= 2, area, torch.zeros_like(area))


def keypoints_person_distance(a: torch.Tensor, b: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mean pixel distance over parts visible in both skeletons. (K, 3),
    (K, 3) -> scalar; inf when no part is visible in both."""
    vis = (a[:, 2] > threshold) & (b[:, 2] > threshold)
    d = torch.linalg.vector_norm(a[:, :2] - b[:, :2], dim=-1)
    n = vis.sum()
    mean = torch.where(vis, d, torch.zeros_like(d)).sum() / torch.clamp(n, min=1)
    return torch.where(n > 0, mean, torch.full_like(mean, float("inf")))


def keep_top_n_people(
    keypoints: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor, n: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``n`` highest-scoring people (``KeepTopNPeople``): capacity
    stays P, survivors move to the front in score order (a stable sort,
    as ``jnp.argsort``), the rest are masked. Works over leading batch
    dims. Returns (keypoints, scores, mask)."""
    ranked = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(-ranked, dim=-1, stable=True).indices  # descending; masked sink
    kp = keypoints.gather(-3, order[..., None, None].expand(keypoints.shape))
    sc = scores.gather(-1, order)
    mk = mask.gather(-1, order) & (torch.arange(mask.shape[-1], device=mask.device) < n)
    return kp, torch.where(mk, sc, torch.zeros_like(sc)), mk
