"""Correspondence-based rigid registration: RANSAC + Umeyama.

Counterpart of ``perception_tpu/ops/registration.py``: all K minimal
(3-point) hypotheses are solved by one batched Kabsch and scored in one
masked reduction; the best one is refit on its inliers.

Triplets are drawn uniformly over the mask from a ``torch.Generator``
(the inverse CDF of ``ops/ransac._sample_indices``), or given as
``indices``. ``torch.linalg.svd`` on CUDA may wait for the card to check
convergence: one batched call and one single call per ``ransac_rigid``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from perception_tpu_torch._tensor import row
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops.ransac import _sample_indices


class RigidFit(NamedTuple):
    transform: torch.Tensor    # (4, 4) src -> dst
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () int32
    valid: torch.Tensor        # () bool


def f32_square(x: float) -> float:
    """x * x rounded as float32 arithmetic rounds it (a traced threshold
    squared under ``jit``)."""
    return float(np.float32(x) * np.float32(x))


def det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _procrustes(H: torch.Tensor, cs: torch.Tensor, cd: torch.Tensor) -> torch.Tensor:
    """Rotation maximising tr(R H) (det-corrected) and the translation
    taking centroid cs to cd: (..., 4, 4)."""
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    det = det3(V @ Ut)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (V * D[..., None, :]) @ Ut
    return se3.make_T(R, cd - (R @ cs[..., None])[..., 0])


def _kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Rigid src->dst for (..., n, 3) pairs (unweighted). The means are a
    sum times 1/n, as XLA computes ``mean`` under ``jit``."""
    inv_n = 1.0 / src.shape[-2]
    cs, cd = src.sum(-2) * inv_n, dst.sum(-2) * inv_n
    H = (src - cs[..., None, :]).transpose(-1, -2) @ (dst - cd[..., None, :])
    return _procrustes(H, cs, cd)


def ransac_rigid(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 0.03,
    num_hypotheses: int = 256,
    min_inliers: int = 6,
    indices: Optional[torch.Tensor] = None,
) -> RigidFit:
    """Robust rigid fit over matched 3-D pairs (N, 3)+(N, 3). Triplets
    come from ``generator``, or as ``indices`` (num_hypotheses, 3)."""
    if indices is None:
        if generator is None:
            raise ValueError("ransac_rigid needs a generator or indices")
        indices = _sample_indices(generator, mask, num_hypotheses)
    idx = indices.to(device=src.device, dtype=torch.int64)
    Ts = _kabsch(src[idx], dst[idx])  # (K, 4, 4)
    R, t = Ts[:, :3, :3], Ts[:, :3, 3]

    thr2 = f32_square(threshold)
    moved = src @ R.transpose(-1, -2) + t[:, None, :]  # (K, N, 3)
    d2 = torch.sum((moved - dst[None]) ** 2, dim=-1)
    inl = (d2 <= thr2) & mask[None, :]
    scores = torch.sum(inl, dim=1, dtype=torch.int32)

    # Degenerate (collinear/repeated) triplets: rotation not orthonormal.
    RtR = R.transpose(-1, -2) @ R
    eye = torch.eye(3, device=src.device)
    ortho = torch.abs(RtR - eye).amax(dim=(1, 2)) < 1e-3
    scores = torch.where(ortho, scores, torch.full_like(scores, -1))

    best = torch.argmax(scores)  # first maximum

    # Refit on the best hypothesis' inliers (weighted Umeyama).
    w = row(inl, best).to(src.dtype)
    wsum = torch.clamp(w.sum(), min=3.0)
    cs = (src * w[:, None]).sum(0) / wsum
    cd = (dst * w[:, None]).sum(0) / wsum
    H = ((src - cs) * w[:, None]).T @ (dst - cd)
    T = _procrustes(H, cs, cd)

    moved = src @ T[:3, :3].T + T[:3, 3]
    inliers = (torch.sum((moved - dst) ** 2, dim=-1) <= thr2) & mask
    num = torch.sum(inliers, dtype=torch.int32)
    return RigidFit(
        transform=T,
        inliers=inliers,
        num_inliers=num,
        valid=(num >= min_inliers) & (row(scores, best) >= 3),
    )
