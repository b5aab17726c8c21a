"""Surface normals of masked clouds and organized depth images.

Counterpart of ``perception_tpu/ops/normals.py``: ``normals_knn``, PCA
over the k nearest neighbours (the smallest eigenvector of the local
scatter), and ``normals_from_depth``, the cross product of
central-difference image tangents. Both orient toward the viewpoint
(PCL's ``flipNormalTowardsViewpoint``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops import nn as _nn

_EIGH_BATCH = 16384


def _orient(normals: torch.Tensor, points: torch.Tensor, viewpoint) -> torch.Tensor:
    to_vp = const(viewpoint, points) - points
    flip = torch.sum(normals * to_vp, dim=-1, keepdim=True) < 0
    return torch.where(flip, -normals, normals)


def normals_knn(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int = 16,
    viewpoint=(0.0, 0.0, 0.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit normals (N, 3) and validity (N,) of a masked (N, 3) cloud by
    local PCA. A normal is valid when at least 3 of its k neighbours are
    real points (masked refs sit at the sentinel, past 1e6 m^2)."""
    idx, d2 = _nn.knn(points, points, mask, k=k)
    neigh = points[idx]
    w = (d2 < 1.0e6).to(points.dtype)
    count = torch.sum(w, dim=-1, keepdim=True)
    mean = torch.sum(neigh * w[..., None], dim=-2, keepdim=True) / torch.clamp(count[..., None], min=1.0)
    centered = (neigh - mean) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    # cuSOLVER's batched eigh refuses more than 16384 matrices a call (the
    # H100 host, torch 2.11); each matrix is solved alone, so chunks give
    # the same vectors.
    evecs = torch.cat([torch.linalg.eigh(c)[1] for c in cov.split(_EIGH_BATCH)])
    normals = evecs[..., 0]
    normals = normals / torch.clamp(torch.linalg.vector_norm(normals, dim=-1, keepdim=True), min=1e-12)
    normals = _orient(normals, points, viewpoint)
    return normals, mask & (count[..., 0] >= 3)


def normals_from_depth(
    points_hw3: torch.Tensor,
    valid_hw: torch.Tensor,
    viewpoint=(0.0, 0.0, 0.0),
    max_edge: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals (H, W, 3) and validity (H, W) of an organized cloud.

    A normal is valid when its pixel and the four neighbours are valid
    and both tangents are shorter than ``max_edge`` metres (no depth
    discontinuity)."""
    p = points_hw3
    # Central differences with edge replication.
    du = torch.cat([p[:, 1:2] - p[:, 0:1], (p[:, 2:] - p[:, :-2]) * 0.5, p[:, -1:] - p[:, -2:-1]], dim=1)
    dv = torch.cat([p[1:2] - p[0:1], (p[2:] - p[:-2]) * 0.5, p[-1:] - p[-2:-1]], dim=0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    n = _orient(n, p, viewpoint)

    v = valid_hw
    v_l = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    v_r = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    v_u = torch.cat([v[:1], v[:-1]], dim=0)
    v_d = torch.cat([v[1:], v[-1:]], dim=0)
    ok_len = (torch.linalg.vector_norm(du, dim=-1) < max_edge) & (
        torch.linalg.vector_norm(dv, dim=-1) < max_edge
    )
    valid = v & v_l & v_r & v_u & v_d & ok_len & (norm[..., 0] > 1e-12)
    return n, valid
