"""Nearest-neighbor search: tiled brute force.

Counterpart of ``perception_tpu/ops/nn.py``'s ``nearest_neighbor``,
``radius_count`` and ``knn``. The distance tile is ``|q|^2 - 2 q.r^T + |r|^2``; the product
``q @ r^T`` is ``torch.matmul`` (the JAX package leaves it to XLA outside
any kernel). Callers set ``torch.backends.cuda.matmul.allow_tf32 = False``
on the card, or the distances lose all but three decimal digits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perception_tpu_torch.ops.features import _top_k
from perception_tpu_torch.ops.points import SENTINEL, apply_mask

_BIG = 4.0e12  # > (2*SENTINEL)^2; safe in f32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _padded_ref(ref, ref_mask, tile):
    """The masked ref cloud padded with sentinel rows to whole tiles."""
    nr = ref.shape[-2]
    ref = apply_mask(ref, ref_mask)
    tile = min(tile, _round_up(nr, 8))
    num_tiles = -(-nr // tile)
    pad = num_tiles * tile - nr
    if pad:
        ref = torch.cat([ref, ref.new_full(ref.shape[:-2] + (pad, 3), SENTINEL)], dim=-2)
    return ref, tile, num_tiles


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an (M, C) table, or row by row for a batched
    (..., M, C) table and (..., Nq) indices (nearest_neighbor's two forms).
    An index past the end (a masked query's nearest sentinel pad row) reads
    the last row, as JAX's clamped gather does."""
    idx = torch.clamp(idx, max=table.shape[-2] - 1)
    if table.dim() == 2:
        return table[idx]
    return torch.take_along_dim(table, idx[..., None], dim=-2)


def nearest_neighbor(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    tile: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index + squared distance of each query point's nearest valid ref point.

    query: (..., Nq, 3); ref: (Nr, 3) with ref_mask (Nr,), or one ref
    cloud per batch row, (..., Nr, 3) with (..., Nr) (the JAX package's
    vmap over both). Returns (idx (..., Nq) int64, dist2 (..., Nq)
    float32). Within a tile the first minimal index wins; across tiles a
    later tile must be strictly closer, as in the JAX package.
    """
    ref, tile, num_tiles = _padded_ref(ref, ref_mask, tile)
    q_sq = torch.sum(query * query, dim=-1)
    best_d2 = torch.full_like(q_sq, _BIG)
    best_idx = torch.zeros(q_sq.shape, dtype=torch.int64, device=query.device)
    for t in range(num_tiles):
        ref_t = ref[..., t * tile:(t + 1) * tile, :]
        r_sq = torch.sum(ref_t * ref_t, dim=-1)
        cross = query @ ref_t.transpose(-1, -2)
        d2 = q_sq[..., None] - 2.0 * cross + r_sq[..., None, :]
        tile_best, tile_arg = torch.min(d2, dim=-1)
        take = tile_best < best_d2
        best_d2 = torch.where(take, tile_best, best_d2)
        best_idx = torch.where(take, tile_arg + t * tile, best_idx)
    return best_idx, torch.clamp(best_d2, min=0.0)


def radius_count(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    radius: float,
    tile: int = 4096,
) -> torch.Tensor:
    """Number of valid ref points within ``radius`` of each query point:
    (Nq, 3), (Nr, 3), (Nr,) -> (Nq,) int32. Distances are the tiles'
    ``|q|^2 - 2 q.r + |r|^2`` over sentinel-padded ref tiles, as in the JAX
    package, so a point within rounding of the radius counts as it does
    there."""
    ref, tile, num_tiles = _padded_ref(ref, ref_mask, tile)
    q_sq = torch.sum(query * query, dim=-1)
    r2 = radius * radius
    count = torch.zeros(query.shape[0], dtype=torch.int32, device=query.device)
    for t in range(num_tiles):
        ref_t = ref[t * tile:(t + 1) * tile]
        r_sq = torch.sum(ref_t * ref_t, dim=-1)
        d2 = q_sq[:, None] - 2.0 * (query @ ref_t.T) + r_sq[None, :]
        count = count + torch.sum(d2 <= r2, dim=1, dtype=torch.int32)
    return count


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    k: int = 8,
    tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid ref points of each query: (idx (Nq, k) int64,
    dist2 (Nq, k)), nearest first.

    A streaming top-k merge across ref tiles: the running k best, then the
    tile, re-selected by a stable sort, so equal distances keep the lower
    position (the running best before the tile, a tile in index order),
    as ``lax.top_k`` does."""
    ref, tile, num_tiles = _padded_ref(ref, ref_mask, tile)
    nq = query.shape[0]
    q_sq = torch.sum(query * query, dim=-1)
    best_d2 = torch.full((nq, k), _BIG, dtype=query.dtype, device=query.device)
    best_idx = torch.zeros((nq, k), dtype=torch.int64, device=query.device)
    cols = torch.arange(tile, device=query.device)
    for t in range(num_tiles):
        ref_t = ref[t * tile:(t + 1) * tile]
        r_sq = torch.sum(ref_t * ref_t, dim=-1)
        d2 = q_sq[:, None] - 2.0 * (query @ ref_t.T) + r_sq[None, :]
        merged_d2 = torch.cat([best_d2, d2], dim=1)
        merged_idx = torch.cat([best_idx, (cols + t * tile).expand(nq, tile)], dim=1)
        neg_top, arg_top = _top_k(-merged_d2, k)
        best_d2, best_idx = -neg_top, torch.gather(merged_idx, 1, arg_top)
    return best_idx, torch.clamp(best_d2, min=0.0)
