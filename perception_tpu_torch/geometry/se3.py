"""SO(3)/SE(3) Lie-group utilities on torch tensors (f32, batch-friendly).

Counterpart of ``perception_tpu/geometry/se3.py``: a rigid transform is a
(..., 4, 4) homogeneous matrix, a twist is xi = (rho, omega) in R^6 with
the translation part first, and every function broadcasts over leading
batch dims.
"""

from __future__ import annotations

import torch

from perception_tpu_torch._tensor import const, norm_rn, sqrt_rn

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


def vee(omega_hat: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) skew -> (..., 3)."""
    return torch.stack(
        [omega_hat[..., 2, 1], omega_hat[..., 0, 2], omega_hat[..., 1, 0]], dim=-1
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation,
    with the same theta_sq < 1e-8 Taylor branches as the JAX package."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = sqrt_rn(theta_sq + _EPS * _EPS)
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
    theta = sqrt_rn(theta_sq + _EPS * _EPS)
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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), through the
    branchless Shepperd quaternion: omega = 2 atan2(|v|, w) v / |v|."""
    q = matrix_to_quat(R)
    v, w = q[..., :3], q[..., 3]
    # The shorter rotation (w >= 0), so theta lies in [0, pi].
    v = torch.where(w[..., None] < 0, -v, v)
    w = torch.abs(w)
    vnorm = norm_rn(v)
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(
        vnorm < 1e-6,
        const(2.0, w) / torch.clamp(w, min=_EPS),
        theta / torch.clamp(vnorm, min=_EPS),
    )
    return scale[..., None] * v


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) = (rho, omega).

    The V solve is ``solve_ex``: ``torch.linalg.solve`` would wait for
    the card to check for a singular matrix."""
    omega = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(omega)
    rho = torch.linalg.solve_ex(V, T[..., :3, 3:])[0][..., 0]
    return torch.cat([rho, omega], dim=-1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = const([0.0, 0.0, 0.0, 1.0], R).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def orthonormalize_T(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block of (..., 4, 4) back onto SO(3) by
    Gram-Schmidt. ``inverse`` (a transpose) doubles any symmetric
    deviation per round trip, so every long-lived pose goes through
    this projection."""
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / torch.clamp(norm_rn(c0, keepdim=True), min=_EPS)
    c1 = R[..., :, 1]
    c1 = c1 - torch.sum(c0 * c1, dim=-1, keepdim=True) * c0
    c1 = c1 / torch.clamp(norm_rn(c1, keepdim=True), min=_EPS)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    return make_T(torch.stack([c0, c1, c2], dim=-1), T[..., :3, 3])


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


def rotate_points(T: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of (..., 4, 4) to vectors (..., N, 3)."""
    return vectors @ T[..., :3, :3].transpose(-1, -2)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) in (x, y, z, w) order (tf convention) -> (..., 3, 3).

    The norm is formed as XLA's CPU code forms ``jnp.linalg.norm``: four
    ``vfmadd213ps`` from 0 over the squares in order, emulated in float64
    (a product of two float32 values is exact there) with one rounding to
    float32 a step, then a correctly rounded root (``vsqrtps``;
    :func:`sqrt_rn`)."""
    q64 = q.double()
    acc = (q64[..., 0] * q64[..., 0]).float()
    for i in (1, 2, 3):
        acc = (q64[..., i] * q64[..., i] + acc.double()).float()
    q = q / sqrt_rn(acc)[..., None]
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (x, y, z, w).

    Shepperd's method, branchless: all four candidate encodings, the one
    with the largest pivot kept (``argmax`` takes the first, as jnp's)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return sqrt_rn(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, s0 / 4.0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2, (m02 - m20) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0, (m10 - m01) / s3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return q / norm_rn(q, keepdim=True)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors along the first row."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) back onto SO(3) by SVD, det +1 enforced:
    ``U diag(1, 1, det(U Vt)) Vt``. On CUDA the SVD reads the card twice.

    A float32 input is projected in float64 and rounded once: a float32
    SVD's error (up to ~1e-6 on a noisy rotation) depends on the LAPACK
    build and on the CPU it dispatches for, so the float32 result would
    change with the host."""
    R64 = R.double() if R.dtype == torch.float32 else R
    U, _, Vh = torch.linalg.svd(R64)
    d = torch.ones(R64.shape[:-1], dtype=R64.dtype, device=R.device)
    d = torch.cat([d[..., :2], _det3(U @ Vh)[..., None]], dim=-1)
    return ((U * d[..., None, :]) @ Vh).to(R.dtype)
