"""Perspective-n-Point pose refinement (motion-only bundle adjustment).

Counterpart of ``perception_tpu/ops/pnp.py``: a fixed-iteration
Gauss-Newton loop over a 6-dof twist with IRLS Huber weights, each
iteration one batched residual/Jacobian evaluation and a 6x6 solve.
Every function broadcasts over leading batch dims, so ``pnp_ransac``
runs all of its hypotheses' GN solves as one batch (the JAX package
vmaps them). The solve is ``solve_ex``, which does not wait for the card.

The intrinsics enter as tensors on the points' device, so ``fx * x / z``
is a true float32 division there too, as in the JAX package's ``jit``
where they are traced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from perception_tpu_torch._tensor import const, consts, row
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops.ransac import _sample_indices


class PnPResult(NamedTuple):
    transform: torch.Tensor      # (..., 4, 4) maps model-frame points into camera frame
    mean_px_error: torch.Tensor  # (...) robust mean reprojection error (pixels)
    num_used: torch.Tensor       # (...) int32 observations with positive depth + mask


def _reproject(T, points, uv, mask, fx, fy, cx, cy):
    """Residuals r (..., N, 2), camera points pc (..., N, 3), gate (..., N)."""
    pc = se3.transform_points(T, points)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    r = torch.stack([u, v], dim=-1) - uv
    gate = mask & (pc[..., 2] > 1e-2)
    return torch.where(gate[..., None], r, torch.zeros((), device=r.device)), pc, gate


def huber_weight(rn: torch.Tensor, delta: float) -> torch.Tensor:
    """1 inside ``delta``, ``delta / rn`` outside (a true division)."""
    d = const(delta, rn)
    return torch.where(rn <= d, torch.ones((), device=rn.device), d / torch.clamp(rn, min=1e-9))


def pnp_gn(
    points: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    T_init: Optional[torch.Tensor] = None,
    iterations: int = 8,
    huber_px: float = 4.0,
    damping: float = 1e-3,
) -> PnPResult:
    """Refine a camera pose from 3D-2D correspondences.

    Args:
      points: (..., N, 3) model-frame 3-D points.
      uv: (..., N, 2) measured pixel coordinates in the target camera.
      mask: (..., N) valid correspondences.
      T_init: (..., 4, 4) initial model->camera transform (identity if None).

    Returns the refined transform plus the robust mean pixel error over
    the gated correspondences.
    """
    points = points.to(torch.float32)
    uv = uv.to(torch.float32)
    dev = points.device
    fx, fy, cx, cy = consts(points, fx, fy, cx, cy)
    batch = points.shape[:-2]
    if T_init is None:
        T = torch.eye(4, device=dev).expand(batch + (4, 4))
    else:
        T = T_init.to(torch.float32)
    eye6 = damping * torch.eye(6, device=dev)
    I3 = torch.eye(3, device=dev).expand(points.shape[:-1] + (3, 3))

    for _ in range(iterations):
        r, pc, gate = _reproject(T, points, uv, mask, fx, fy, cx, cy)
        z = torch.clamp(pc[..., 2], min=1e-6)
        zero = torch.zeros_like(z)
        # d(u,v)/d(pc): the pinhole projection Jacobian.
        Jproj = torch.stack(
            [
                torch.stack([fx / z, zero, -fx * pc[..., 0] / (z * z)], dim=-1),
                torch.stack([zero, fy / z, -fy * pc[..., 1] / (z * z)], dim=-1),
            ],
            dim=-2,
        )  # (..., N, 2, 3)
        # Left-multiplicative update T <- exp(xi) T: d pc/d xi = [I | -hat(pc)].
        dpc = torch.cat([I3, -se3.hat(pc)], dim=-1)  # (..., N, 3, 6)
        J = Jproj @ dpc  # (..., N, 2, 6)

        w = huber_weight(torch.linalg.vector_norm(r, dim=-1), huber_px) * gate
        Jw = J * w[..., None, None]
        A = torch.einsum("...nai,...naj->...ij", Jw, J) + eye6
        b = -torch.einsum("...nai,...na->...i", Jw, r)
        xi = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
        T = se3.se3_exp(xi) @ T
    T = se3.orthonormalize_T(T)

    r, _, gate = _reproject(T, points, uv, mask, fx, fy, cx, cy)
    rn = torch.linalg.vector_norm(r, dim=-1)
    n = torch.sum(gate, dim=-1, dtype=torch.int32)
    err = torch.sum(torch.where(gate, torch.clamp(rn, max=4.0 * huber_px), torch.zeros((), device=dev)), dim=-1)
    err = err / torch.clamp(n.to(torch.float32), min=1.0)
    return PnPResult(transform=T, mean_px_error=err, num_used=n)


def pnp_ransac(
    points: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator],
    fx,
    fy,
    cx,
    cy,
    threshold_px: float = 4.0,
    num_hypotheses: int = 64,
    min_inliers: int = 8,
    iterations: int = 6,
    indices: Optional[torch.Tensor] = None,
) -> Tuple[PnPResult, torch.Tensor, torch.Tensor]:
    """Robust PnP: batched 4-point GN hypotheses scored by reprojection.

    Every hypothesis runs a short GN from identity on its own minimal set
    (one batched ``pnp_gn``), scores are inlier counts over all
    correspondences, and the winner is polished on its inliers. The
    4-point sets come from ``generator``, or as ``indices``
    (num_hypotheses, 4). Returns (result, inliers (N,), valid ())."""
    points = points.to(torch.float32)
    uv = uv.to(torch.float32)
    if indices is None:
        if generator is None:
            raise ValueError("pnp_ransac needs a generator or indices")
        indices = _sample_indices(generator, mask, num_hypotheses, 4)
    idx = indices.to(device=points.device, dtype=torch.int64)
    fxj, fyj, cxj, cyj = consts(points, fx, fy, cx, cy)

    sel_mask = torch.ones(idx.shape, dtype=torch.bool, device=points.device)
    Ts = pnp_gn(points[idx], uv[idx], sel_mask, fxj, fyj, cxj, cyj, iterations=iterations).transform

    pc = points @ Ts[:, :3, :3].transpose(-1, -2) + Ts[:, None, :3, 3]  # (K, N, 3)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fxj * pc[..., 0] / z + cxj
    v = fyj * pc[..., 1] / z + cyj
    err = torch.sqrt((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2)
    inl = (err <= threshold_px) & mask[None, :] & (pc[..., 2] > 1e-2)
    scores = torch.sum(inl, dim=1, dtype=torch.int32)
    best = torch.argmax(scores)

    res = pnp_gn(points, uv, row(inl, best), fxj, fyj, cxj, cyj, T_init=row(Ts, best), iterations=iterations)
    r, _, gate = _reproject(res.transform, points, uv, mask, fxj, fyj, cxj, cyj)
    inliers = (torch.linalg.vector_norm(r, dim=-1) <= threshold_px) & gate
    num = torch.sum(inliers, dtype=torch.int32)
    return res, inliers, num >= min_inliers
