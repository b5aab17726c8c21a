"""Sparse visual features: FAST corners, oriented BRIEF, Hamming match.

Counterpart of ``perception_tpu/ops/features.py``:

- FAST-9 on 16 shifted copies of the image; a contiguous arc of >= 9
  brighter or darker ring pixels marks a corner, scored by the sum of
  absolute differences; 3x3 max-pool NMS, then the top-K scores;
- 256-bit BRIEF on a box-blurred image, steered by the intensity-centroid
  orientation, packed as 8 words of 32 bits;
- mutual-best Hamming matching with a ratio test.

Descriptors are ``int32`` tensors holding the JAX package's ``uint32``
bits (torch's ``uint32`` support is partial): ``np.asarray(desc).view(
np.int32)`` carries them across. Hamming distances count bits with a SWAR
popcount, masking after every arithmetic right shift.

Top-K selections that can tie (FAST scores on quantized gray, match
scores ``-d1``) use a stable descending sort, which keeps XLA ``top_k``'s
order: equal values in ascending index order. The ring's 16-term sums run
in ring order, as XLA's reduction does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from perception_tpu_torch._tensor import const

# 16-pixel Bresenham circle of radius 3 (clockwise from 12 o'clock).
FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)  # (dx, dy)


class Keypoints(NamedTuple):
    uv: torch.Tensor      # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor   # (K,) corner response
    angle: torch.Tensor   # (K,) orientation radians
    mask: torch.Tensor    # (K,) valid


def _top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties in ascending
    index order (a stable descending sort)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _ordered_sum(stack: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0, left to right."""
    acc = stack[0]
    for k in range(1, stack.shape[0]):
        acc = acc + stack[k]
    return acc


def fast_detect(
    img: torch.Tensor,
    threshold: float = 20.0,
    max_keypoints: int = 512,
    arc: int = 9,
    border: int = 16,
    subpixel: bool = False,
) -> Keypoints:
    """FAST-N corner detection on a grayscale (H, W) float image."""
    H, W = img.shape
    img = img.to(torch.float32)
    dev = img.device
    ring = torch.stack([torch.roll(img, (int(dy), int(dx)), (0, 1)) for dx, dy in FAST_CIRCLE])

    bright = ring > (img + threshold)[None]
    dark = ring < (img - threshold)[None]

    # Contiguous circular arc >= `arc`: every window of the doubled ring.
    def has_arc(b):
        return torch.cat([b, b]).unfold(0, arc, 1)[:16].all(dim=-1).any(dim=0)

    is_corner = has_arc(bright) | has_arc(dark)

    # Score: sum of |intensity difference| over the responding pixels.
    diff = torch.abs(ring - img[None]) - threshold
    zero = torch.zeros((), device=dev)
    raw = torch.maximum(_ordered_sum(torch.where(bright, diff, zero)),
                        _ordered_sum(torch.where(dark, diff, zero)))
    minus1 = torch.full((), -1.0, device=dev)
    score = torch.where(is_corner, raw, minus1)

    # Border mask (descriptor patch must fit).
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    score = torch.where(inb, score, minus1)

    # 3x3 NMS: keep pixels equal to their neighborhood max (-inf padding).
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score == pooled, score, minus1)

    top_scores, top_idx = _top_k(score.reshape(-1), max_keypoints)
    py_i = top_idx // W
    px_i = top_idx % W
    valid = top_scores > 0

    xs = px_i.to(torch.float32)
    ys = py_i.to(torch.float32)
    if subpixel:
        # 1-D parabola fits on the raw (pre-NMS) response along x and y.
        def _at(dy, dx):
            return raw[torch.clamp(py_i + dy, 0, H - 1), torch.clamp(px_i + dx, 0, W - 1)]

        c = _at(0, 0)
        denom_x = _at(0, -1) - 2.0 * c + _at(0, 1)
        denom_y = _at(-1, 0) - 2.0 * c + _at(1, 0)
        dx = torch.where(torch.abs(denom_x) > 1e-6, 0.5 * (_at(0, -1) - _at(0, 1)) / denom_x, zero)
        dy = torch.where(torch.abs(denom_y) > 1e-6, 0.5 * (_at(-1, 0) - _at(1, 0)) / denom_y, zero)
        xs = xs + torch.clamp(dx, -0.5, 0.5)
        ys = ys + torch.clamp(dy, -0.5, 0.5)

    # Orientation: intensity centroid over a 15x15 patch.
    r = 7
    offs = torch.arange(-r, r + 1, device=dev)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    patch_y = torch.clamp(py_i[:, None, None] + oy[None], 0, H - 1)
    patch_x = torch.clamp(px_i[:, None, None] + ox[None], 0, W - 1)
    patches = img[patch_y, patch_x]  # (K, 15, 15)
    m01 = torch.sum(patches * oy[None].to(torch.float32), dim=(1, 2))
    m10 = torch.sum(patches * ox[None].to(torch.float32), dim=(1, 2))
    angle = torch.atan2(m01, m10)

    return Keypoints(
        uv=torch.stack([xs, ys], dim=-1),
        score=torch.where(valid, top_scores, zero),
        angle=torch.where(valid, angle, zero),
        mask=valid,
    )


def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 42) -> np.ndarray:
    """Fixed Gaussian test-pair pattern, (n_bits, 4) = (x1, y1, x2, y2)
    offsets; the JAX package's, drawn from the same ``RandomState``."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    pts = np.clip(rng.randn(n_bits, 4) * sigma, -(patch // 2), patch // 2)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()
# Bit weights 1 << b as int32 (bit 31 is the sign bit).
_BIT_WEIGHTS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32)


def _window_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-padded size x size window sums, added in row-major window
    order (as XLA's reduce_window adds)."""
    H, W = x.shape
    xp = F.pad(x, (size // 2,) * 4)
    acc = xp[:H, :W]
    for k in range(1, size * size):
        dy, dx = divmod(k, size)
        acc = acc + xp[dy:dy + H, dx:dx + W]
    return acc


def box_blur(img: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Mean filter (the smoothing BRIEF needs): the in-bounds window sum
    times the reciprocal of the in-bounds count. That is how XLA computes
    the JAX package's ``s / c`` under ``jit``: the count is a constant, and
    XLA turns a division by a constant into a reciprocal multiply. Bit for
    bit equal to ``jax.jit(box_blur)``; eager JAX divides and may differ by
    an ulp."""
    x = img.to(torch.float32)
    return _window_sum(x, size) * (1.0 / _window_sum(torch.ones_like(x), size))


def brief_describe(img: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """Steered BRIEF-256 descriptors: (K, 8) int32 holding 32 bits each.

    The test pattern is rotated by each keypoint's orientation and
    sampled with nearest-neighbor gathers from the blurred image.
    """
    H, W = img.shape
    smooth = box_blur(img, 5)
    pat = const(_PATTERN, kps.uv)  # (256, 4)

    ca, sa = torch.cos(kps.angle), torch.sin(kps.angle)  # (K,)

    def rot(x, y):
        xr = ca[:, None] * x[None, :] - sa[:, None] * y[None, :]
        yr = sa[:, None] * x[None, :] + ca[:, None] * y[None, :]
        return xr, yr

    x1, y1 = rot(pat[:, 0], pat[:, 1])
    x2, y2 = rot(pat[:, 2], pat[:, 3])

    def sample(xo, yo):
        xs = torch.clamp(torch.round(kps.uv[:, 0:1] + xo), 0, W - 1).to(torch.int64)
        ys = torch.clamp(torch.round(kps.uv[:, 1:2] + yo), 0, H - 1).to(torch.int64)
        return smooth[ys, xs]  # (K, 256)

    bits = (sample(x1, y1) < sample(x2, y2)).to(torch.int32).reshape(-1, 8, 32)
    weights = torch.from_numpy(_BIT_WEIGHTS).to(bits.device, non_blocking=True)
    # Distinct powers of two: the int32 sum is the bitwise OR.
    return torch.sum(bits * weights, dim=-1, dtype=torch.int32)


class Matches(NamedTuple):
    idx_a: torch.Tensor     # (M,) int32 index into set A
    idx_b: torch.Tensor     # (M,) int32 index into set B
    distance: torch.Tensor  # (M,) hamming distance
    mask: torch.Tensor      # (M,) valid


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR). ``>>`` is arithmetic on int32,
    so every shift is masked before its bits are counted."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # bytes of at most 8; bit 31 clear
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., Na, 8) x (..., Nb, 8) int32 descriptors -> (..., Na, Nb) int32 distances."""
    x = desc_a[..., :, None, :] ^ desc_b[..., None, :, :]
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def match_descriptors(
    desc_a: torch.Tensor,
    mask_a: torch.Tensor,
    desc_b: torch.Tensor,
    mask_b: torch.Tensor,
    max_distance: int = 64,
    ratio: float = 0.8,
    max_matches: int = 256,
) -> Matches:
    """Mutual-best Hamming matching with Lowe ratio test.

    Broadcasts over leading dims: (..., Na, 8) against (..., Nb, 8)
    matches many pairs of sets in one call (the JAX package vmaps)."""
    dist = hamming(desc_a, desc_b)
    big = 512
    dist = torch.where(mask_a[..., :, None] & mask_b[..., None, :], dist,
                       torch.full((), big, dtype=torch.int32, device=dist.device))

    best_b = torch.argmin(dist, dim=-1)  # (..., Na), first minimum
    d_sorted = torch.topk(dist, 2, dim=-1, largest=False).values  # two smallest, ascending
    d1, d2 = d_sorted[..., 0], d_sorted[..., 1]
    best_a_of_b = torch.argmin(dist, dim=-2)  # (..., Nb)
    na = dist.shape[-2]
    mutual = torch.gather(best_a_of_b, -1, best_b) == torch.arange(na, device=dist.device)
    ok = (
        mutual
        & (d1 <= max_distance)
        & (d1.to(torch.float32) <= ratio * torch.clamp(d2.to(torch.float32), min=1.0))
        & mask_a
    )

    score = torch.where(ok, -d1, torch.full((), -big, dtype=torch.int32, device=dist.device))
    top, idx_a = _top_k(score, max_matches)
    idx_b = torch.gather(best_b, -1, idx_a)
    return Matches(
        idx_a=idx_a.to(torch.int32),
        idx_b=idx_b.to(torch.int32),
        distance=(-top).to(torch.int32),
        mask=top > -big,
    )
