"""Voxel-hash nearest-neighbour search for large clouds.

Counterpart of ``perception_tpu/ops/voxelhash.py``. ``build`` quantises
the reference cloud to cells of the search radius on a grid fitted to
its bounds and sorts it by cell id once. ``query`` takes the queries in
tiles of spatially coherent points; each tile's 27-cell neighbourhood
lies inside one contiguous range of the cell-sorted table, which the
kernel (``ops/kernels/voxelhash_query.py``) scans for the exact
``(q - p)^2`` minimum. Per-query work follows the points in the tile's
range, not the map size.

Exactness: a true neighbour within ``cell_size`` of a query lies in its
tile's range unless the range overflowed the ``rng_pts`` cap, which
``return_stats`` reports as the fraction of tiles that did.

Production pattern (ICP): ``sort_by_cell`` the source once per frame,
then query with ``sort=False`` every Gauss-Newton iteration.

The grid extents, sentinel id and cell size are device tensors, as the
JAX package's traced leaves are, so a rebuild never waits for the card.
The JAX package's transposed ``tableT`` (for its HBM-streaming kernel)
has no counterpart: one kernel serves every table size.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query
from perception_tpu_torch.ops.points import SENTINEL, apply_mask, bounds

_TABLE_PAD = 1024  # table rows padded to this multiple (divisible by rblk)
# Range-start alignment rule kept from the JAX package, where the TPU's
# HBM-streaming kernel (tables past this many rows) needs 128-row-aligned
# DMA offsets and the VMEM one 8-row sublane offsets. The alignment
# decides which rows a tile covers, and so the overflow fraction and the
# index of a far miss; keeping the rule keeps the results equal.
_ALIGN_128_ABOVE_ROWS = 49152


class VoxelHash(NamedTuple):
    points: torch.Tensor       # (N, 3) sorted by cell id (masked rows at SENTINEL, last)
    table: torch.Tensor        # (Npad, 8) rows [x, y, z, 1, 0...]; padding rows SENTINEL
    cell_ids: torch.Tensor     # (N,) int32 sorted
    origin: torch.Tensor       # (3,)
    cell_size: torch.Tensor    # ()
    dims: torch.Tensor         # (3,) int32 grid extents
    sentinel_id: torch.Tensor  # () int32 id of invalid slots
    order: torch.Tensor        # (N,) int32 original index per sorted slot


def _cell_ids(pts, origin, cell_size, dims):
    cell = torch.floor((pts - origin) / cell_size).to(torch.int32)
    cell = torch.minimum(torch.clamp(cell, min=0), dims - 1)
    return (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] + cell[..., 2]


def build(ref: torch.Tensor, ref_mask: torch.Tensor, cell_size: float) -> VoxelHash:
    """Fit the grid to the masked cloud's bounds (one guard cell a side,
    at most 1200 cells an axis) and sort by cell id."""
    cs = const(cell_size, ref)
    lo, hi = bounds(ref, ref_mask)
    origin = lo - cs
    dims = torch.clamp(torch.ceil((hi - origin) / cs).to(torch.int32) + 2, 1, 1200)
    ref_p = apply_mask(ref, ref_mask)
    ids = _cell_ids(ref, origin, cs, dims)
    sentinel = dims[0] * dims[1] * dims[2]
    ids = torch.where(ref_mask, ids, sentinel)
    sorted_ids, order = torch.sort(ids, stable=True)
    pts_sorted = ref_p[order]

    n = pts_sorted.shape[0]
    # One spare block of sentinel rows past the data: chunk windows are
    # rblk-quantised, so a range flush with the table end has slack.
    npad = -(-max(n, 1) // _TABLE_PAD) * _TABLE_PAD + _TABLE_PAD
    table = ref.new_zeros((npad, 8))
    table[:, :3] = SENTINEL
    table[:n, :3] = pts_sorted
    table[:n, 3] = 1.0
    return VoxelHash(
        points=pts_sorted,
        table=table,
        cell_ids=sorted_ids,
        origin=origin,
        cell_size=cs,
        dims=dims,
        sentinel_id=sentinel,
        order=order.to(torch.int32),
    )


def sort_by_cell(vh: VoxelHash, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pts sorted into this hash's cell order, order), a stable sort."""
    _, order = torch.sort(_cell_ids(pts, vh.origin, vh.cell_size, vh.dims), stable=True)
    return pts[order], order


def _tile_ranges(vh: VoxelHash, q_pad, nq: int, tile: int, R: int, rblk: int, align: int = 8):
    """Per-tile contiguous candidate range in the sorted table.

    Correct for any query order (min/max over the tile's real cell ids),
    tight when tiles are coherent. Returns (start (ntiles,) int32 in units
    of ``align`` rows, nchunk (ntiles,) int32 rblk-chunk counts, overflow
    fraction of tiles whose range passed the R cap)."""
    dims = vh.dims
    nqp = q_pad.shape[0]
    ntiles = nqp // tile
    slop = dims[1] * dims[2] + dims[2] + 1  # +-1 x-slab + y-row + z-cell

    cid = _cell_ids(q_pad, vh.origin, vh.cell_size, dims)
    valid = (torch.arange(nqp, device=q_pad.device) < nq).reshape(ntiles, tile)
    cid_t = cid.reshape(ntiles, tile)
    mincid = torch.where(valid, cid_t, 2**31 - 1).amin(dim=1)
    maxcid = torch.where(valid, cid_t, -1).amax(dim=1)
    lo = mincid - slop
    hi = maxcid + slop + 1
    starts = torch.searchsorted(vh.cell_ids, lo, out_int32=True)
    ends = torch.searchsorted(vh.cell_ids, hi, out_int32=True)

    npad = vh.table.shape[0]
    # One align-unit of slack covers the down-quantisation, so the range
    # tail is never cut.
    start_a = torch.div(torch.clamp(starts, 0, max(npad - rblk, 0)), align, rounding_mode="floor") * align
    span = torch.clamp(ends, max=npad) - start_a
    nchunk = torch.clamp(-torch.div(-span, rblk, rounding_mode="floor"), 1, R // rblk)
    nchunk = torch.minimum(nchunk, torch.div(npad - start_a, rblk, rounding_mode="floor"))
    nchunk = torch.clamp(nchunk, min=1).to(torch.int32)
    live = maxcid >= 0
    overflow = torch.sum(((ends - starts) > (R - align)) & live) / torch.clamp(torch.sum(live), min=1)
    return torch.div(start_a, align, rounding_mode="floor").to(torch.int32), nchunk, overflow


def _auto_params(nq: int, m: int, npad: int, rblk: int):
    """Tile size from the query/map ratio (sparse queries, small tiles;
    512 at most), range cap from the table size."""
    ratio = nq / max(m, 1)
    if ratio >= 8:
        tile = 512
    elif ratio >= 2:
        tile = 256
    else:
        tile = 128
    rng = min(npad, 16384)
    rng = -(-rng // rblk) * rblk
    return tile, rng


def query(
    vh: VoxelHash,
    queries: torch.Tensor,
    tile: int | None = None,
    rng_pts: int | None = None,
    rblk: int = 512,
    sort: bool = True,
    return_stats: bool = False,
):
    """Nearest reference point per query within ~cell_size.

    Returns (idx (Nq,) int32 into the *sorted* hash points, dist2 (Nq,))
    [+ overflow fraction with ``return_stats``]; dist2 is sentinel-scale
    where no candidate cell held a neighbour. ``sort=False`` keeps the
    caller's order (after ``sort_by_cell``)."""
    nq = queries.shape[0]
    if sort:
        _, order_q = torch.sort(_cell_ids(queries, vh.origin, vh.cell_size, vh.dims), stable=True)
        queries = queries[order_q]
    args, overflow = kernel_args(vh, queries, tile, rng_pts, rblk)
    idx, d2 = voxelhash_query(*args)

    idx = torch.clamp(idx[:nq], max=vh.points.shape[0] - 1)
    d2 = d2[:nq]
    if sort:
        idx = torch.empty_like(idx).index_put_((order_q,), idx)
        d2 = torch.empty_like(d2).index_put_((order_q,), d2)
    if return_stats:
        return idx, d2, overflow
    return idx, d2


def kernel_args(vh: VoxelHash, queries, tile: int | None = None, rng_pts: int | None = None,
                rblk: int = 512):
    """What ``query`` hands the kernel for queries in their final order:
    ((table, padded queries, row starts, chunk counts, tile, R, rblk),
    overflow fraction)."""
    nq = queries.shape[0]
    npad_t = vh.table.shape[0]
    auto_tile, auto_rng = _auto_params(nq, vh.points.shape[0], npad_t, rblk)
    tile = auto_tile if tile is None else tile
    rng_pts = auto_rng if rng_pts is None else rng_pts
    R = min(rng_pts + rblk, npad_t) // rblk * rblk
    pad = torch.full(((-nq) % tile, 3), SENTINEL, dtype=queries.dtype, device=queries.device)
    q_pad = torch.cat([queries, pad])
    align = 128 if npad_t > _ALIGN_128_ABOVE_ROWS else 8
    start_u, nchunk, overflow = _tile_ranges(vh, q_pad, nq, tile, R, rblk, align=align)
    return (vh.table, q_pad, start_u * align, nchunk, tile, R, rblk), overflow


def nearest_neighbor_voxelhash(query_pts, ref, ref_mask, radius: float):
    """One-shot build + query: (neighbour points (Nq, 3), dist2, found);
    neighbours farther than ``radius`` are misses."""
    vh = build(ref, ref_mask, cell_size=radius)
    idx, d2 = query(vh, query_pts)
    return vh.points[idx], d2, d2 <= radius * radius
