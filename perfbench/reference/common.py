"""Shared pieces of the plain reference: precision, SE(3), nearest neighbours.

Everything is plain PyTorch in float32 with TF32 off. ``Precision("tf32")``
is the control: every matrix product rounds its two operands to TF32's
10-bit mantissa (round to nearest even) before a float32 product, which
is what a TF32 matmul on the card computes, on any device.
"""

from __future__ import annotations

import contextlib

import torch

SENTINEL = 1.0e6


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float32 with a 10-bit mantissa (ties to even)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision:
    """The arithmetic of one reference run: "float32" or "tf32" (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(w: torch.Tensor):
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th * th * th))
    return a, b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twists (..., 6) = (rho, omega) -> transforms (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    a, b, c = _coeffs(w)
    K = hat(w)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return make_T(R, (V @ rho[..., None])[..., 0])


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), computed in float64."""
    R64 = R.double()
    cos = ((R64[..., 0, 0] + R64[..., 1, 1] + R64[..., 2, 2]) - 1.0) / 2.0
    v = torch.stack([R64[..., 2, 1] - R64[..., 1, 2], R64[..., 0, 2] - R64[..., 2, 0],
                     R64[..., 1, 0] - R64[..., 0, 1]], -1)
    sin = torch.linalg.vector_norm(v, dim=-1) / 2.0
    th = torch.atan2(sin, cos)  # well conditioned at small angles, unlike arccos
    small = sin < 1e-9
    s = torch.where(small, torch.full_like(th, 0.5), th / (2.0 * torch.where(small, torch.ones_like(sin), sin)))
    return (s[..., None] * v).to(R.dtype)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Transforms (..., 4, 4) -> twists (..., 6) = (rho, omega)."""
    w = so3_log(T[..., :3, :3])
    _, b, c = _coeffs(w)
    K = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    V = eye + b[..., None, None] * K + c[..., None, None] * (K @ K)
    rho = torch.linalg.solve(V, T[..., :3, 3:])[..., 0]
    return torch.cat([rho, w], dim=-1)


def rotation_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle in radians of Ra^T Rb, in float64."""
    return torch.linalg.vector_norm(so3_log(Ra.double().transpose(-1, -2) @ Rb.double()), dim=-1)


def transform(T: torch.Tensor, p: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Points (..., N, 3) under transforms (..., 4, 4)."""
    return prec.mm(p, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def nearest(query: torch.Tensor, ref: torch.Tensor, prec: Precision, tile: int = 4096):
    """Brute nearest neighbour by ``|q|^2 - 2 q.r + |r|^2``: query (..., Nq, 3)
    against ref (M, 3) whose masked rows sit at the sentinel. Returns
    (index (..., Nq), squared distance clamped at 0); the first of equal
    minima wins."""
    q_sq = (query * query).sum(-1)
    best = torch.full_like(q_sq, float("inf"))
    arg = torch.zeros(q_sq.shape, dtype=torch.int64, device=query.device)
    for s in range(0, ref.shape[0], tile):
        r = ref[s:s + tile]
        d2 = q_sq[..., None] - 2.0 * prec.mm(query, r.T) + (r * r).sum(-1)
        m, i = torch.min(d2, dim=-1)
        take = m < best
        best = torch.where(take, m, best)
        arg = torch.where(take, i + s, arg)
    return arg, torch.clamp(best, min=0.0)


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(r), delta / torch.clamp(a, min=1e-12))


def gn_step(T, src_t, q, nrm, w, damping: float, prec: Precision):
    """One damped point-to-plane Gauss-Newton update exp(xi) @ T for lanes
    (..., N): residual r = n.(p - q), weights w (gate x Huber)."""
    r = (nrm * (src_t - q)).sum(-1)
    J = torch.cat([nrm, torch.linalg.cross(src_t, nrm, dim=-1)], dim=-1)
    Jw = J * w[..., None]
    A = prec.mm(Jw.transpose(-1, -2), J) + damping * torch.eye(6, dtype=J.dtype, device=J.device)
    b = -prec.mm(Jw.transpose(-1, -2), r[..., None])
    xi = torch.linalg.solve(A.double(), b.double())[..., 0].to(J.dtype)
    return se3_exp(xi) @ T, xi
