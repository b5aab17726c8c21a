"""Camera rays and SE(3) exponentials in float64 for the scene renderers."""

from __future__ import annotations

import math

import torch


def camera_rays(camera: dict, device) -> torch.Tensor:
    """(H, W, 3) float64 rays ``((u - cx) / fx, (v - cy) / fy, 1)`` of a
    camera given as ``{"width", "height", "fx", "fy", "cx", "cy"}``."""
    H, W = camera["height"], camera["width"]
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                            torch.arange(W, dtype=torch.float64, device=device), indexing="ij")
    return torch.stack([(uu - camera["cx"]) / camera["fx"], (vv - camera["cy"]) / camera["fy"],
                        torch.ones_like(uu)], dim=-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twists (..., 6) = (rho, omega) -> (..., 4, 4), Rodrigues' formula."""
    rho, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / (safe * safe * safe))
    z = torch.zeros_like(th)
    K = torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                     torch.stack([w[..., 2], z, -w[..., 0]], -1),
                     torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    KK = K @ K
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


TWO_PI = 2.0 * math.pi
