"""Linear resampling as ``jax.image`` computes it.

Counterpart of ``jax.image.resize(..., "bilinear")`` and
``jax.image.scale_and_translate(..., "bilinear")``, which the JAX
package's pose and hand paths call. It is not ``F.interpolate``: JAX
antialiases when it downsamples (the triangle kernel widens by
1/scale), normalises each output sample's weights, and zeroes samples
that fall outside the input. ``compute_weight_mat`` is a copy of
``jax/_src/image/scale.py::compute_weight_mat`` for the triangle kernel
with antialiasing on (JAX's default); the image is contracted with one
dense weight matrix per spatial axis.

Rounding: JAX contracts both axes in one einsum at HIGHEST precision in
an order opt_einsum picks, and under ``jit`` it may fuse or reorder the
weights' arithmetic; the port contracts rows, then columns. The results
agree to float32 rounding, not bit for bit. Every function works on the
last two axes, (..., H, W).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from perception_tpu_torch._tensor import fp32

_EPS32 = 1.1920928955078125e-07  # np.finfo(np.float32).eps


def _weights(input_size: int, output_size: int, inv_scale, translation) -> torch.Tensor:
    """The body of JAX's ``compute_weight_mat`` from ``inv_scale = 1 / scale``."""
    dev, dt = inv_scale.device, inv_scale.dtype
    kernel_scale = torch.clamp(inv_scale, min=1.0)  # antialias when downsampling
    out_pos = torch.arange(output_size, dtype=dt, device=dev)
    in_pos = torch.arange(input_size, dtype=dt, device=dev)
    inv, ks = inv_scale[..., None], kernel_scale[..., None, None]
    sample_f = (out_pos + 0.5) * inv - translation[..., None] * inv - 0.5  # (..., out)
    x = (sample_f[..., None, :] - in_pos[:, None]).abs() / ks              # (..., in, out)
    weights = torch.clamp(1.0 - x, min=0.0)                                 # triangle kernel
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def compute_weight_mat(input_size: int, output_size: int, scale, translation) -> torch.Tensor:
    """(..., input_size, output_size) linear-resampling weights.

    ``scale`` and ``translation`` are float32 tensors of one shape (the
    leading dims: one matrix per box) on the weights' device; 1/scale is
    a float32 division there, as JAX takes it for a traced scale.
    """
    return _weights(input_size, output_size, 1.0 / scale, translation)


@fp32()
def _apply(x: torch.Tensor, wy, wx) -> torch.Tensor:
    """Contract (..., H, W) with (.., H, h) over rows and (.., W, w) over
    columns; a None matrix leaves its axis as it is."""
    if wy is not None:
        x = torch.matmul(wy.transpose(-1, -2), x)
    if wx is not None:
        x = torch.matmul(x, wx)
    return x


@functools.lru_cache(maxsize=32)
def _resize_weights(m: int, n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``jax.image.resize``'s weights for one axis m -> n. There ``scale =
    n / m`` is a Python float, so 1/scale is taken in double and rounded
    to float32 once; translation is 0. They depend on the sizes alone, so
    each (m, n, device) is built once; no caller writes to them."""
    inv = torch.tensor(1.0 / (n / m), dtype=torch.float32).to(device, non_blocking=True)
    return _weights(m, n, inv, torch.zeros_like(inv)).to(dtype)


def resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., *out_hw), "bilinear")`` over the last two
    axes: an axis whose size does not change is left as it is."""
    (h, w), (H, W) = x.shape[-2:], out_hw
    wy = _resize_weights(h, H, x.device, x.dtype) if h != H else None
    wx = _resize_weights(w, W, x.device, x.dtype) if w != W else None
    return _apply(x, wy, wx)


def scale_and_translate_each(x: torch.Tensor, out_hw: Tuple[int, int], scale: torch.Tensor,
                             translation: torch.Tensor) -> torch.Tensor:
    """``scale_and_translate`` with one warp per image: ``x`` (B..., H, W)
    and ``scale``, ``translation`` (B..., 2) -> (B..., out_h, out_w)."""
    H, W = x.shape[-2:]
    wy = compute_weight_mat(H, out_hw[0], scale[..., 0], translation[..., 0])
    wx = compute_weight_mat(W, out_hw[1], scale[..., 1], translation[..., 1])
    return _apply(x, wy, wx)


def scale_and_translate(x: torch.Tensor, out_hw: Tuple[int, int], scale: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate`` over the last two axes of ``x``
    (..., H, W), with ``scale`` and ``translation`` (B..., 2) float32
    tensors in (y, x) order: one warp per leading index of ``scale``.
    Returns (B..., ..., out_h, out_w): each warp of all of ``x``."""
    H, W = x.shape[-2:]
    lead = scale.shape[:-1]
    wy = compute_weight_mat(H, out_hw[0], scale[..., 0], translation[..., 0])  # (B..., H, h)
    wx = compute_weight_mat(W, out_hw[1], scale[..., 1], translation[..., 1])  # (B..., W, w)
    extra = x.dim() - 2
    shape = lead + (1,) * extra
    return _apply(x, wy.reshape(shape + wy.shape[-2:]), wx.reshape(shape + wx.shape[-2:]))
