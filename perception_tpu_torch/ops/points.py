"""Masked point-cloud primitives: filters, voxel downsample, compaction.

Counterpart of ``perception_tpu/ops/points.py``. A cloud is
``(points[N, 3] float32, mask[N] bool)``; ops keep N fixed and narrow
the mask, and masked-out points are parked at ``SENTINEL``.

The elementwise ops broadcast over leading batch dims. The sort-based
ops (``voxel_downsample*``, ``compact``, ``dominant_blob_filter``) take
one frame; the batched pipeline loops over frames for them (ROADMAP.md,
Queue 2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from perception_tpu_torch._tensor import const

# Far-away park position for invalid points: keeps them out of every
# radius/NN query without introducing NaN/inf into arithmetic.
SENTINEL = 1.0e6


def apply_mask(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Park masked-out points at the sentinel location."""
    return torch.where(mask[..., None], points, const(SENTINEL, points))


def passthrough(
    points: torch.Tensor, mask: torch.Tensor, axis: int, lo: float, hi: float
) -> torch.Tensor:
    """PassThrough filter: keep points with lo <= p[axis] <= hi (mask only)."""
    v = points[..., axis]
    return mask & (v >= lo) & (v <= hi)


def crop_box(points: torch.Tensor, mask: torch.Tensor, lo, hi) -> torch.Tensor:
    """Axis-aligned box filter (inclusive); lo/hi are length-3."""
    inside = torch.all((points >= const(lo, points)) & (points <= const(hi, points)), dim=-1)
    return mask & inside


def centroid(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over valid points: (..., N, 3), (..., N) -> (..., 3)."""
    w = mask.to(points.dtype)
    total = torch.sum(points * w[..., None], dim=-2)
    count = torch.sum(w, dim=-1, keepdim=True)
    return total / torch.clamp(count, min=1.0)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows of ``values`` (N, ...) summed by segment -> (num_segments, ...),
    the same on every call. On the CPU ``index_add_`` adds in row order. On
    CUDA it adds floats with atomics in no fixed order, so a centroid moved
    by an ulp from call to call; there ``index_put_`` with ``accumulate``
    sorts the ids stably and adds each segment's rows in turn."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    if values.device.type == "cuda":
        return out.index_put_((segment_ids,), values, accumulate=True)
    return out.index_add_(0, segment_ids, values)


def voxel_ids(points: torch.Tensor, origin: torch.Tensor, voxel_size, dims) -> torch.Tensor:
    """Linear int64 voxel ids on a fixed grid; out-of-grid cells clamp."""
    cell = torch.floor((points - origin) / const(voxel_size, points)).to(torch.int64)
    c = [torch.clamp(cell[..., a], 0, dims[a] - 1) for a in range(3)]
    return (c[0] * dims[1] + c[1]) * dims[2] + c[2]


def voxel_downsample(
    points: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    origin=None,
    dims=(1024, 1024, 1024),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """VoxelGrid downsample of one frame: slot i holds the centroid of the
    i-th occupied voxel in voxel-id order (a prefix mask)."""
    centroids, _, out_mask = voxel_downsample_with_attrs(
        points, mask, None, voxel_size, origin=origin, dims=dims
    )
    return centroids, out_mask


def voxel_downsample_with_attrs(
    points: torch.Tensor,
    mask: torch.Tensor,
    attrs,
    voxel_size: float,
    origin=None,
    dims=(1024, 1024, 1024),
    weights=None,
):
    """VoxelGrid downsample carrying optional (N, A) attributes and
    optional (N,) point weights. Returns (centroids, attr_means | None,
    mask), all at the input capacity N.

    The JAX package's ``lax.sort`` of (ids, iota) is a stable
    ``torch.sort`` here and its ``segment_sum`` is ``segment_sum`` (the
    same sums on every call; on CUDA a centroid can differ from the CPU's
    in the last ulp)."""
    n = points.shape[0]
    vs = const(voxel_size, points)
    if origin is None:
        lo = torch.where(mask[:, None], points, const(float("inf"), points)).amin(dim=0)
        lo = torch.where(torch.isfinite(lo), lo, const(0.0, points))
        origin = (torch.floor(lo / vs) - 1.0) * vs
    elif not isinstance(origin, torch.Tensor):
        origin = const(origin, points)
    ids = voxel_ids(points, origin, voxel_size, dims)
    # Invalid points get an id past every real voxel so they sort last.
    big = dims[0] * dims[1] * dims[2]
    ids = torch.where(mask, ids, torch.full_like(ids, big))

    sorted_ids, order = torch.sort(ids, stable=True)
    valid_sorted = sorted_ids < big
    first = torch.ones_like(valid_sorted)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first = first & valid_sorted
    rank_sorted = torch.cumsum(first.to(torch.int64), dim=0) - 1
    rank_sorted = torch.where(valid_sorted, rank_sorted, torch.full_like(rank_sorted, n - 1))

    w = valid_sorted.to(points.dtype)
    if weights is not None:
        w = w * torch.clamp(torch.as_tensor(weights, dtype=points.dtype)[order], min=0.0)
    sums = segment_sum(points[order] * w[:, None], rank_sorted, n)
    counts = segment_sum(w, rank_sorted, n)
    out_mask = counts > 0
    # Empty segments give 0/eps = 0 and are masked out anyway.
    denom = torch.clamp(counts, min=1e-12)[:, None]
    centroids = sums / denom
    attr_means = None
    if attrs is not None:
        attr_sums = segment_sum(attrs[order] * w[:, None], rank_sorted, n)
        attr_means = attr_sums / denom
    return apply_mask(centroids, out_mask), attr_means, out_mask


def _keep_positions(mask: torch.Tensor, capacity: int, dtype):
    """Decimation keep-mask (+ front-compacted rank, informational).

    Keep valid point r iff floor(r * ratio) advances, ratio =
    capacity/cnt; every valid point is kept when cnt <= capacity."""
    cnt = torch.sum(mask, dtype=torch.int64)
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    ratio = torch.clamp(cnt, max=capacity).to(dtype) / torch.clamp(cnt, min=1).to(dtype)
    r = rank.to(dtype)
    advance = torch.floor((r + 1.0) * ratio) > torch.floor(r * ratio)
    keep = mask & ((cnt <= capacity) | advance)
    pos = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    pos = torch.where(keep, torch.clamp(pos, max=capacity), torch.full_like(pos, capacity))
    return keep, pos


def compact(
    points: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather valid points of one frame to the front, reducing/padding to
    ``capacity``; over capacity an evenly spaced subset is kept."""
    keep, _ = _keep_positions(mask, capacity, points.dtype)
    # Kept first, stable; CUDA's sort takes no bool keys, so sort uint8.
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    idx = order[:capacity]
    out_mask = keep[idx]
    return apply_mask(points[idx], out_mask), out_mask


def compact_with_attrs(
    points: torch.Tensor, mask: torch.Tensor, attrs: torch.Tensor, capacity: int
):
    """compact() that also gathers per-point (N, A) attributes: returns
    (points (capacity, 3), attrs (capacity, A), mask (capacity,))."""
    keep, _ = _keep_positions(mask, capacity, points.dtype)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    idx = order[:capacity]
    out_mask = keep[idx]
    return apply_mask(points[idx], out_mask), attrs[idx], out_mask


def compact_prefix(
    points: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """compact() for prefix masks (all valid slots lead): one gather of
    ``capacity`` evenly spaced valid rows, no sort."""
    cnt = torch.sum(mask, dtype=torch.int64)
    out_rank = torch.arange(capacity, dtype=torch.int64, device=points.device)
    kept = torch.clamp(cnt, max=capacity)
    idx = (out_rank * cnt) // torch.clamp(kept, min=1)
    idx = torch.clamp(idx, max=points.shape[0] - 1)
    out_mask = out_rank < kept
    return apply_mask(points[idx], out_mask), out_mask


def bounds(points: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked min/max corners of a cloud (SENTINEL/-SENTINEL when empty)."""
    big = const(SENTINEL, points)
    lo = torch.where(mask[..., None], points, big).amin(dim=-2)
    hi = torch.where(mask[..., None], points, -big).amax(dim=-2)
    return lo, hi


def dominant_blob_filter(
    points: torch.Tensor,
    mask: torch.Tensor,
    cell: float = 0.05,
    radius: float = 0.18,
    origin=(-5.0, -5.0, -5.0),
    dims=(256, 256, 256),
) -> torch.Tensor:
    """Keep points of one frame within ``radius`` of the densest coarse
    voxel's centroid. Returns the narrowed mask."""
    n = points.shape[0]
    ids = voxel_ids(points, const(origin, points), cell, dims)
    ids = torch.where(mask, ids, torch.full_like(ids, -1))
    sorted_ids, order = torch.sort(ids, stable=True)
    valid_sorted = sorted_ids >= 0
    first = torch.ones_like(valid_sorted)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    first = first & valid_sorted
    rank = torch.cumsum(first.to(torch.int64), dim=0) - 1
    rank = torch.where(valid_sorted, rank, torch.full_like(rank, n))
    counts = torch.zeros(n + 1, dtype=torch.int64, device=points.device)
    counts = counts.index_add_(0, rank, valid_sorted.to(torch.int64))[:n]
    sums = segment_sum(points[order] * valid_sorted[:, None], rank, n + 1)[:n]
    best = torch.argmax(counts)
    center = sums[best] / torch.clamp(counts[best], min=1)
    d2 = torch.sum((points - center) ** 2, dim=-1)
    return mask & (d2 <= radius * radius)
