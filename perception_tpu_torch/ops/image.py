"""2-D image ops: colour space, thresholding, morphology, component bbox,
resize.

Counterpart of ``perception_tpu/ops/image.py``: the OpenCV calls of the
reference's colour object detector (``cvtColor(BGR2HSV)``, ``inRange``,
5x5 ``erode``/``dilate``, ``findContours`` + ``contourArea`` +
``boundingRect``) on tensors, and ``bilinear_resize``. Morphology is a
max pool over a padded mask; the contour step is connected-components
labelling (min-label propagation with pointer jumping) and a masked bbox
reduction, run for a fixed number of rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.resize import resize


def rgb_to_hsv_cv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB uint8/float (H, W, 3) -> OpenCV-convention HSV: H in [0, 180),
    S in [0, 255], V in [0, 255] (all float32)."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    safe_c = torch.where(c == 0, one, c)
    h = torch.where(
        v == r, (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    h = torch.where(c == 0, zero, h) * 30.0  # 60 deg / 2 (OpenCV H range)
    h = torch.where(h < 0, h + 180.0, h)
    s = torch.where(v == 0, zero, c / torch.where(v == 0, one, v)) * 255.0
    return torch.stack([h, s, v], dim=-1)


def in_range(img: torch.Tensor, lo, hi) -> torch.Tensor:
    """cv2.inRange: bool mask of pixels with lo <= px <= hi per channel."""
    return torch.all((img >= const(lo, img)) & (img <= const(hi, img)), dim=-1)


def _morph(mask: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """One ``size`` x ``size`` erosion or dilation of an (H, W) mask. Erosion
    pads with 1 (foreground), as the JAX package does, not with OpenCV's
    border; it is a max pool of the negated mask. Exact on 0/1 values."""
    x = mask.to(torch.float32)[None, None]
    pad = size // 2
    if op == "erode":
        x = F.pad(-x, (pad, pad, pad, pad), value=-1.0)
        out = -F.max_pool2d(x, size, stride=1)
    else:
        x = F.pad(x, (pad, pad, pad, pad), value=0.0)
        out = F.max_pool2d(x, size, stride=1)
    return out[0, 0] > 0.5


def erode(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _morph(mask, size, "erode")
    return mask


def dilate(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _morph(mask, size, "dilate")
    return mask


class ComponentBBox(NamedTuple):
    x1: torch.Tensor
    y1: torch.Tensor
    x2: torch.Tensor    # max column of the component
    y2: torch.Tensor
    area: torch.Tensor  # pixel count of the largest component
    valid: torch.Tensor  # () bool: any foreground at all


def largest_component_bbox(mask: torch.Tensor, max_iters: int = 64) -> ComponentBBox:
    """Bounding box of the largest 4-connected foreground component of an
    (H, W) mask; int32 fields.

    Labels start as the linear pixel index; each round takes the minimum
    over the 4-neighbourhood, then jumps each label to its pixel's label.
    The JAX package loops until nothing changes or ``max_iters`` rounds;
    this runs exactly ``max_iters`` rounds, with no host read: a converged
    labelling is a fixed point, and where the cap stops JAX it stops here.
    The largest component is the first maximum of the label counts, as
    ``jnp.argmax``."""
    H, W = mask.shape
    n = H * W
    dev = mask.device
    big = torch.full((), n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev).reshape(H, W)
    labels = torch.where(mask, idx, big)
    row_pad = big.expand(1, W)
    col_pad = big.expand(H, 1)
    for _ in range(max_iters):
        up = torch.cat([row_pad, labels[:-1]], 0)
        down = torch.cat([labels[1:], row_pad], 0)
        left = torch.cat([col_pad, labels[:, :-1]], 1)
        right = torch.cat([labels[:, 1:], col_pad], 1)
        m = torch.minimum(torch.minimum(up, down), torch.minimum(left, right))
        new = torch.where(mask, torch.minimum(labels, m), big)
        jump = new.reshape(-1)[torch.clamp(new, 0, n - 1).reshape(-1)].reshape(H, W)
        labels = torch.where(mask, torch.minimum(new, jump), big)

    flat = labels.reshape(-1)
    seg = torch.clamp(flat, 0, n)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    counts = counts.index_add_(0, seg, mask.reshape(-1).to(torch.int32))[:n]  # bin n: the background
    root = torch.argmax(counts)
    area = counts.gather(0, root.reshape(1))[0]
    comp = (flat == root).reshape(H, W)
    cols = torch.any(comp, dim=0)
    rows = torch.any(comp, dim=1)
    xs = torch.arange(W, dtype=torch.int32, device=dev)
    ys = torch.arange(H, dtype=torch.int32, device=dev)
    x1 = torch.amin(torch.where(cols, xs, torch.full_like(xs, W)))
    x2 = torch.amax(torch.where(cols, xs, torch.full_like(xs, -1)))
    y1 = torch.amin(torch.where(rows, ys, torch.full_like(ys, H)))
    y2 = torch.amax(torch.where(rows, ys, torch.full_like(ys, -1)))
    return ComponentBBox(x1=x1, y1=y1, x2=x2, y2=y2, area=area, valid=area > 0)


def bilinear_resize(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, out_hw + img.shape[2:], "bilinear")`` of an
    (H, W) or (H, W, C) image: antialiased when it downsamples
    (``ops/resize.py``), unlike ``F.interpolate``."""
    if img.dim() == 2:
        return resize(img, out_hw)
    return resize(img.movedim(-1, 0), out_hw).movedim(0, -1)
