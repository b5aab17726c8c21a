"""Batched-hypothesis RANSAC plane segmentation.

Counterpart of ``perception_tpu/ops/ransac.py``. All K hypotheses are
sampled at once and scored in one fused pass (``ops/kernels/
ransac_score``); the best one is refined by a least-squares fit over its
inliers. Every function takes one frame (N, 3) or a batch (B, N, 3).

Plane convention: coefficients (a, b, c, d) with unit normal and
a*x + b*y + c*z + d = 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.kernels.ransac_score import ransac_score


class PlaneFit(NamedTuple):
    coefficients: torch.Tensor  # (..., 4) [a, b, c, d], |n| = 1
    inliers: torch.Tensor       # (..., N) bool
    num_inliers: torch.Tensor   # (...,) int32
    valid: torch.Tensor         # (...,) bool — a usable hypothesis was found


def _sample_indices(generator: torch.Generator, mask: torch.Tensor, num: int, k: int = 3) -> torch.Tensor:
    """(..., num, k) int64 indices of valid points, uniform over the mask.

    Inverse CDF over the mask's cumsum: draw uniform valid ranks in
    [1, cnt], then one ``searchsorted(side="left")`` maps rank -> row.
    The uniforms come from ``generator`` on its own device."""
    csum = torch.cumsum(mask.to(torch.int64), dim=-1)
    cnt = torch.clamp(csum[..., -1:], min=1)  # (..., 1)
    u = torch.rand(mask.shape[:-1] + (num * k,), generator=generator,
                   device=generator.device, dtype=torch.float64).to(mask.device)
    ranks = torch.minimum((u * cnt).to(torch.int64) + 1, cnt)
    idx = torch.searchsorted(csum, ranks, side="left")
    idx = torch.clamp(idx, max=mask.shape[-1] - 1)
    return idx.reshape(mask.shape[:-1] + (num, k))


def _plane_from_triplets(p0, p1, p2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit normals (..., K, 3), offsets d (..., K) and a non-degenerate flag."""
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    ok = norm[..., 0] > 1e-10
    n = n / torch.clamp(norm, min=1e-12)
    d = -torch.sum(n * p0, dim=-1)
    return n, d, ok


def _score(points, mask, normals, d, threshold):
    """Inlier count per hypothesis through a matmul: the plain oracle.

    (..., N, 3) @ (..., 3, K) -> (..., N, K) distances; (..., K) int32."""
    dist = torch.abs(points @ normals.transpose(-1, -2) + d[..., None, :])
    inl = (dist <= threshold) & mask[..., :, None]
    return torch.sum(inl, dim=-2, dtype=torch.int32)


def _score_fused(points, mask, normals, d, threshold):
    """Production scorer: the fused kernel on (B, N, 3) clouds."""
    hyp = torch.cat([normals, d[..., None]], dim=-1).contiguous()
    return ransac_score(points.contiguous(), mask.contiguous(), hyp, threshold)


def _refit(points, mask, inliers) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares plane over inliers: smallest eigenvector of the scatter."""
    w = (inliers & mask).to(points.dtype)
    count = torch.clamp(torch.sum(w, dim=-1), min=3.0)[..., None]
    mean = torch.sum(points * w[..., None], dim=-2) / count
    centered = (points - mean[..., None, :]) * w[..., None]
    cov = centered.transpose(-1, -2) @ centered / count[..., None]  # (..., 3, 3)
    _, evecs = torch.linalg.eigh(cov)
    n = evecs[..., :, 0]
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    d = -torch.sum(n * mean, dim=-1)
    return n, d


def _plane_distance(points, n, d):
    """|points . n + d| per point: (..., N, 3), (..., 3), (...,) -> (..., N)."""
    return torch.abs((points @ n[..., :, None])[..., 0] + d[..., None])


def ransac_plane(
    points: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 0.01,
    num_hypotheses: int = 1024,
    model: str = "plane",
    axis: Optional[torch.Tensor] = None,
    eps_angle: float = 0.1,
    min_inliers: int = 10,
    indices: Optional[torch.Tensor] = None,
) -> PlaneFit:
    """Segment the dominant plane of one cloud (N, 3) or a batch (B, N, 3).

    model: 'plane' | 'perpendicular' (normal within eps_angle of axis) |
    'parallel' (normal within eps_angle of 90 deg to axis). Triplets are
    drawn from ``generator``, or given as ``indices`` (num_hypotheses, 3)
    or (B, num_hypotheses, 3) rows of ``points``.
    """
    if model not in ("plane", "perpendicular", "parallel"):
        raise ValueError(f"unknown model {model!r}")
    if model != "plane" and axis is None:
        raise ValueError(f"model={model!r} requires an axis")
    single = points.dim() == 2
    if single:
        points, mask = points[None], mask[None]
        if indices is not None and indices.dim() == 2:
            indices = indices[None]
    if indices is None:
        if generator is None:
            raise ValueError("ransac_plane needs a generator or indices")
        indices = _sample_indices(generator, mask, num_hypotheses)
    idx = indices.to(device=points.device, dtype=torch.int64)
    B = points.shape[0]
    rows = torch.arange(B, device=points.device)[:, None]
    p0, p1, p2 = (points[rows, idx[..., j]] for j in range(3))
    normals, d, nondegenerate = _plane_from_triplets(p0, p1, p2)

    scores = _score_fused(points, mask, normals, d, threshold)
    minus_one = torch.full_like(scores, -1)
    scores = torch.where(nondegenerate, scores, minus_one)

    if model != "plane":
        ax = axis.to(points)
        ax = ax / torch.clamp(torch.linalg.vector_norm(ax), min=1e-12)
        cosang = torch.abs(normals @ ax)
        if model == "perpendicular":
            ok = cosang >= torch.cos(const(eps_angle, points))
        else:
            ok = cosang <= torch.sin(const(eps_angle, points))
        scores = torch.where(ok, scores, minus_one)

    best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    best_score = scores[rows[:, 0], best]
    n_best, d_best = normals[rows[:, 0], best], d[rows[:, 0], best]

    # Refine on the winning hypothesis' inliers, then re-collect inliers
    # against the refined plane.
    inl0 = (_plane_distance(points, n_best, d_best) <= threshold) & mask
    n_ref, d_ref = _refit(points, mask, inl0)
    # Keep the refined plane's orientation consistent with the sample.
    flip = torch.sign(torch.sum(n_ref * n_best, dim=-1))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    n_ref, d_ref = n_ref * flip[:, None], d_ref * flip

    # If the refit drifted outside an axis constraint, keep the raw
    # hypothesis (constraint satisfaction beats LS optimality).
    if model != "plane":
        cos_ref = torch.abs(n_ref @ ax)
        if model == "perpendicular":
            ok_ref = cos_ref >= torch.cos(const(eps_angle, points))
        else:
            ok_ref = cos_ref <= torch.sin(const(eps_angle, points))
        n_ref = torch.where(ok_ref[:, None], n_ref, n_best)
        d_ref = torch.where(ok_ref, d_ref, d_best)

    inliers = (_plane_distance(points, n_ref, d_ref) <= threshold) & mask
    num = torch.sum(inliers, dim=-1, dtype=torch.int32)
    valid = (best_score >= min_inliers) & (num >= min_inliers)
    fit = PlaneFit(
        coefficients=torch.cat([n_ref, d_ref[:, None]], dim=-1),
        inliers=inliers,
        num_inliers=num,
        valid=valid,
    )
    if single:
        fit = PlaneFit(*(t[0] for t in fit))
    return fit


def point_plane_distance(points: torch.Tensor, coefficients: torch.Tensor) -> torch.Tensor:
    """Signed distance of points (..., 3) to plane (4,)."""
    return points @ coefficients[:3] + coefficients[3]
