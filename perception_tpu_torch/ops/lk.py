"""Pyramidal Lucas-Kanade sparse optical flow.

Counterpart of ``perception_tpu/ops/lk.py``: coarse-to-fine iterative LK
over an image pyramid with every keypoint batched; each iteration is one
(K, P, P) bilinear patch gather and a batched 2x2 solve. The JAX
package's ``lax.scan`` of ``iterations`` steps per level is a fixed
Python loop; nothing reads the card back. Divisions by constants are
multiplies by their reciprocals, and the 2x2 pooling adds its four
pixels in row-major order, as XLA compiles the first level of the
jitted JAX function; XLA picks other orders for some smaller levels, so
those agree to an ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perception_tpu_torch._tensor import const


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling (..., H, W) -> (..., H//2, W//2)."""
    H, W = img.shape[-2:]
    h2, w2 = H // 2, W // 2
    r = img[..., :h2 * 2, :w2 * 2].reshape(img.shape[:-2] + (h2, 2, w2, 2))
    return (r[..., 0, :, 0] + r[..., 0, :, 1] + r[..., 1, :, 0] + r[..., 1, :, 1]) * 0.25


def build_pyramid(img: torch.Tensor, levels: int):
    pyr = [img.float()]
    for _ in range(levels - 1):
        pyr.append(_downsample2(pyr[-1]))
    return pyr


def _gather_patch(img: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """(..., K, 2) float centres -> (..., K, P, P) bilinear patches of the
    (H, W) image, sample positions clipped to [0, W - 1.001] x [0, H - 1.001]."""
    H, W = img.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    x = torch.clamp(centers[..., 0, None, None] + offs[None, :], 0.0, W - 1.001)
    y = torch.clamp(centers[..., 1, None, None] + offs[:, None], 0.0, H - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    i00 = y0f.to(torch.int64) * W + x0f.to(torch.int64)
    flat = img.reshape(-1)

    def at(i):
        return flat.gather(0, i.reshape(-1)).reshape(i.shape)

    v00, v01, v10, v11 = at(i00), at(i00 + 1), at(i00 + W), at(i00 + W + 1)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


class FlowResult(NamedTuple):
    points: torch.Tensor  # (K, 2) tracked positions in the new image
    valid: torch.Tensor   # (K,) tracking confidence gate
    error: torch.Tensor   # (K,) mean |I0 - I1| over the window


def lk_track(img0: torch.Tensor, img1: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, levels: int = 3,
             radius: int = 7, iterations: int = 10, min_eig: float = 1e-3, max_error: float = 20.0) -> FlowResult:
    """Track (K, 2) points from gray image ``img0`` to ``img1``. A point is
    valid when its template's smaller structure-tensor eigenvalue per
    pixel exceeds ``min_eig`` at every level, it lands inside the image,
    and its window's mean |I0 - I1| is under ``max_error``."""
    pyr0 = build_pyramid(img0, levels)
    pyr1 = build_pyramid(img1, levels)
    n_px = (2 * radius + 1) ** 2
    # Template, x+-1 and y+-1 sample offsets: one gather for all five.
    shifts = const([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], points)[:, None, :]

    flow = torch.zeros_like(points)
    ok = mask
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p0 = points * (1.0 / scale)
        I0, I1 = pyr0[lvl], pyr1[lvl]
        patch0, xp, xm, yp, ym = _gather_patch(I0, p0 + shifts, radius).unbind(0)
        gx = (xp - xm) * 0.5
        gy = (yp - ym) * 0.5
        Gxx = (gx * gx).sum((1, 2))
        Gxy = (gx * gy).sum((1, 2))
        Gyy = (gy * gy).sum((1, 2))
        det = Gxx * Gyy - Gxy * Gxy
        tr = Gxx + Gyy
        eig_min = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5
        ok = ok & (eig_min * (1.0 / n_px) > min_eig)
        d = torch.clamp(det, min=1e-9)

        f = flow * (1.0 / scale)
        for _ in range(iterations):
            it = _gather_patch(I1, p0 + f, radius) - patch0
            bx = -(gx * it).sum((1, 2))
            by = -(gy * it).sum((1, 2))
            step = torch.stack([(Gyy * bx - Gxy * by) / d, (Gxx * by - Gxy * bx) / d], dim=-1)
            f = f + torch.where(ok[:, None], step, torch.zeros_like(step))
        flow = f * scale

    new_pts = points + flow
    err = (_gather_patch(pyr1[0], new_pts, radius) - _gather_patch(pyr0[0], points, radius)).abs().sum((1, 2))
    err = err * (1.0 / n_px)
    H, W = img1.shape
    inb = (new_pts[:, 0] >= 0) & (new_pts[:, 0] < W) & (new_pts[:, 1] >= 0) & (new_pts[:, 1] < H)
    return FlowResult(points=new_pts, valid=ok & inb & (err < max_error), error=err)
