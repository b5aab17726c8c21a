"""Nearest-neighbor search: tiled brute force.

Counterpart of ``perception_tpu/ops/nn.py``'s ``nearest_neighbor``. The
distance tile is ``|q|^2 - 2 q.r^T + |r|^2``; the product ``q @ r^T``
is ``torch.matmul`` (the JAX package leaves it to XLA outside any
kernel). Callers set ``torch.backends.cuda.matmul.allow_tf32 = False``
on the card, or the distances lose all but three decimal digits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perception_tpu_torch.ops.points import SENTINEL, apply_mask

_BIG = 4.0e12  # > (2*SENTINEL)^2; safe in f32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def nearest_neighbor(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    tile: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index + squared distance of each query point's nearest valid ref point.

    query: (..., Nq, 3); ref: (Nr, 3); ref_mask: (Nr,). Returns
    (idx (..., Nq) int64, dist2 (..., Nq) float32). Within a tile the
    first minimal index wins; across tiles a later tile must be strictly
    closer, as in the JAX package.
    """
    nr = ref.shape[0]
    ref = apply_mask(ref, ref_mask)
    q_sq = torch.sum(query * query, dim=-1)

    tile = min(tile, _round_up(nr, 8))
    num_tiles = -(-nr // tile)
    pad = num_tiles * tile - nr
    if pad:
        ref = torch.cat([ref, ref.new_full((pad, 3), SENTINEL)])

    best_d2 = torch.full_like(q_sq, _BIG)
    best_idx = torch.zeros(q_sq.shape, dtype=torch.int64, device=query.device)
    for t in range(num_tiles):
        ref_t = ref[t * tile:(t + 1) * tile]
        r_sq = torch.sum(ref_t * ref_t, dim=-1)
        cross = query @ ref_t.T
        d2 = q_sq[..., None] - 2.0 * cross + r_sq
        tile_best, tile_arg = torch.min(d2, dim=-1)
        take = tile_best < best_d2
        best_d2 = torch.where(take, tile_best, best_d2)
        best_idx = torch.where(take, tile_arg + t * tile, best_idx)
    return best_idx, torch.clamp(best_d2, min=0.0)
