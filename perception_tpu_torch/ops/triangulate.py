"""Multi-view triangulation: batched DLT + Gauss-Newton refinement.

Counterpart of ``perception_tpu/ops/triangulate.py``, the reference's
``PoseTriangulation`` (``openpose/src/openpose/3d/poseTriangulation.cpp``):
DLT (``:119-155``) followed by Huber-weighted reprojection refinement
(the reference's Ceres AutoDiff + HuberLoss(2.0), ``:228-269``), here a
fixed number of batched Gauss-Newton steps with a 3x3 system per point.

The DLT takes the smallest eigenvector of each point's 4x4 ``A^T A``, as
the JAX package does (not an SVD of A), so both solve the same problem;
its sign cancels in the divide by w. On CUDA the batched eigh reads the
card once; the GN steps read nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perception_tpu_torch._tensor import const


class TriangulationResult(NamedTuple):
    points: torch.Tensor        # (N, 3) world points
    reproj_error: torch.Tensor  # (N,) mean reprojection error (px)
    valid: torch.Tensor         # (N,)


def triangulate_dlt(
    P_matrices: torch.Tensor,  # (C, 3, 4) projection matrices
    uv: torch.Tensor,          # (N, C, 2) pixel observations
    mask: torch.Tensor,        # (N, C) which cameras see each point
) -> torch.Tensor:
    """Linear DLT: smallest eigenvector of A^T A of the stacked (2C, 4)
    constraint matrix A per point (poseTriangulation.cpp:119-155)."""
    r0 = uv[..., 0:1] * P_matrices[None, :, 2, :] - P_matrices[None, :, 0, :]  # (N, C, 4)
    r1 = uv[..., 1:2] * P_matrices[None, :, 2, :] - P_matrices[None, :, 1, :]
    A = torch.cat([r0, r1], dim=1)  # (N, 2C, 4)
    w = torch.cat([mask, mask], dim=1).to(A.dtype)[..., None]
    A = A * w
    AtA = torch.einsum("nca,ncb->nab", A, A)
    _, V = torch.linalg.eigh(AtA)
    X = V[..., 0]
    w4 = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w4) > 1e-12, w4, torch.full_like(w4, 1e-12))


def _reproject(P_matrices, X):
    """Pixels (N, C, 2) and depths z (N, C): the projection keeps the sign
    of z (a point behind a camera lands mirrored, as in the JAX package)."""
    hom = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (N, 4)
    proj = torch.einsum("cij,nj->nci", P_matrices, hom)  # (N, C, 3)
    z = proj[..., 2:3]
    sign = torch.sign(torch.where(z == 0, torch.ones_like(z), z))
    return proj[..., :2] / torch.clamp(torch.abs(z), min=1e-9) * sign, proj[..., 2]


def triangulate(
    P_matrices: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    iterations: int = 5,
    huber_px: float = 2.0,
    max_reproj_error: float = 25.0,
) -> TriangulationResult:
    """DLT init + ``iterations`` Huber Gauss-Newton steps, batched over
    points: (C, 3, 4), (N, C, 2), (N, C) bool."""
    X = triangulate_dlt(P_matrices, uv, mask)
    wvis = mask.to(uv.dtype)
    P3 = P_matrices[:, :, :3]  # (C, 3, 3)
    eye = 1e-6 * torch.eye(3, dtype=uv.dtype, device=uv.device)
    for _ in range(iterations):
        pred, z = _reproject(P_matrices, X)
        r = (pred - uv) * wvis[..., None]  # (N, C, 2)
        rn = torch.linalg.vector_norm(r, dim=-1)
        hw = torch.where(rn <= huber_px, torch.ones_like(rn), const(huber_px, rn) / torch.clamp(rn, min=1e-9)) * wvis
        # d(pred)/dX per camera: pc = P[:, :3] X + P[:, 3]; u = pc0 / pc2.
        zsafe = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        Ju = (P3[None, :, 0, :] - pred[..., 0:1] * P3[None, :, 2, :]) / zsafe[..., None]
        Jv = (P3[None, :, 1, :] - pred[..., 1:2] * P3[None, :, 2, :]) / zsafe[..., None]
        J = torch.stack([Ju, Jv], dim=2)  # (N, C, 2, 3)
        Jw = J * hw[..., None, None]
        H = torch.einsum("ncai,ncaj->nij", Jw, J) + eye
        g = -torch.einsum("ncai,nca->ni", Jw, r)
        X = X + torch.linalg.solve_ex(H, g[..., None])[0][..., 0]

    pred, _ = _reproject(P_matrices, X)
    err = torch.linalg.vector_norm(pred - uv, dim=-1) * wvis
    nviews = torch.clamp(torch.sum(wvis, dim=1), min=1.0)
    mean_err = torch.sum(err, dim=1) / nviews
    valid = (torch.sum(mask, dim=1) >= 2) & (mean_err < max_reproj_error)
    return TriangulationResult(points=X, reproj_error=mean_err, valid=valid)
