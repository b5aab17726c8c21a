"""SO(3)/SE(3) Lie-group utilities on torch tensors (f32, batch-friendly).

Counterpart of ``perception_tpu/geometry/se3.py``: a rigid transform is a
(..., 4, 4) homogeneous matrix, a twist is xi = (rho, omega) in R^6 with
the translation part first, and every function broadcasts over leading
batch dims.
"""

from __future__ import annotations

import torch

from perception_tpu_torch._tensor import const

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(ox)
    return torch.stack(
        [
            torch.stack([zeros, -oz, oy], dim=-1),
            torch.stack([oz, zeros, -ox], dim=-1),
            torch.stack([-oy, ox, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation,
    with the same theta_sq < 1e-8 Taylor branches as the JAX package."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8

    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS * _EPS),
    )
    K = hat(omega)
    KK = K @ K
    return _eye3(K) + a[..., None, None] * K + b[..., None, None] * KK


def _so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """V matrix of SE(3) exp: integrates rotation along the twist."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8

    b = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS * _EPS),
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta_sq * theta, min=_EPS),
    )
    K = hat(omega)
    KK = K @ K
    return _eye3(K) + b[..., None, None] * K + c[..., None, None] * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = (rho, omega) -> (..., 4, 4) homogeneous transform."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = const([0.0, 0.0, 0.0, 1.0], R).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]
