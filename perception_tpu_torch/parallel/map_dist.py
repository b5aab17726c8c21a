"""Map-block-partitioned point-to-plane odometry.

Counterpart of ``perception_tpu/parallel/map_dist.py``. The local map,
the largest live array of the SLAM system, is split into contiguous row
blocks, one a rank along a 1-D mesh axis (``mp``); the source cloud and
the pose are replicated. One GN iteration:

1. each rank finds each source point's nearest point in its own block
   (``ops/nn.nearest_neighbor``: within a block a tie keeps the first
   index);
2. an ``all_reduce`` (MIN) over ``mp`` gives each point's winning
   distance; a rank whose point is at that distance holds a winner, and
   an ``all_reduce`` (SUM) counts the winners, so a tie across ranks
   splits the point's weight evenly;
3. each rank sums its winners' share of the 6x6 normal equations, and
   one ``all_reduce`` (SUM) completes them;
4. the damped solve and the SE(3) update run on every rank alike.

After the last iteration the correspondences are found once more, and
one ``all_reduce`` sums the weighted count and squared distance of the
gated winners (the fitness).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops.icp import _huber_weight
from perception_tpu_torch.parallel.mesh import Sharding, all_reduce, group


class MapShardedResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) refined source -> map transform
    fitness: torch.Tensor    # () mean squared gated correspondence distance
    num_corr: torch.Tensor   # () int32 gated correspondences


def make_map_sharded_gn(
    mesh: Optional[DeviceMesh],
    iterations: int = 8,
    max_corr_dist: float = 0.25,
    huber_delta: float = 0.02,
    damping: float = 1e-5,
    axis: str = "mp",
):
    """The map-sharded GN step of one rank:
    ``step(map_pts, map_nrm, map_mask, src, src_mask, T0)`` with this rank's
    block of the map rows and the whole source cloud (N, 3), its mask and
    the initial pose. Returns the same result on every rank.
    ``mesh=None`` runs one rank holding the whole map."""
    max_d2 = max_corr_dist * max_corr_dist
    grp = group(mesh, axis)

    def step(map_pts, map_nrm, map_mask, src, src_mask, T0) -> MapShardedResult:
        one = torch.ones((), device=src.device)

        def correspondences(T):
            src_t = se3.transform_points(T, src)
            idx, d2 = _nn.nearest_neighbor(src_t, map_pts, map_mask)
            (best,) = all_reduce([d2], grp, op="min")
            win = (d2 <= best).to(src.dtype)
            (nwin,) = all_reduce([win], grp)
            share = win / torch.maximum(nwin, one)
            gate = src_mask & (best <= max_d2)
            return src_t, idx, best, gate, share

        T = T0
        eye = damping * torch.eye(6, device=src.device)
        for _ in range(iterations):
            src_t, idx, _, gate, share = correspondences(T)
            q = _nn.gather_rows(map_pts, idx)
            nrm = _nn.gather_rows(map_nrm, idx)
            r = torch.sum(nrm * (src_t - q), dim=-1)
            w = gate.to(src.dtype) * share * _huber_weight(r, huber_delta)
            J = torch.cat([nrm, torch.cross(src_t, nrm, dim=-1)], dim=-1)
            Jw = J * w[:, None]
            A, b = all_reduce([Jw.T @ J, -(Jw.T @ r)], grp)
            T = se3.se3_exp(torch.linalg.solve_ex(A + eye, b[:, None])[0][:, 0]) @ T
        _, _, d2, gate, share = correspondences(T)
        num, fit = all_reduce([torch.sum(gate * share), torch.sum(torch.where(gate, d2, 0.0) * share)], grp)
        return MapShardedResult(transform=T, fitness=fit / torch.maximum(num, one), num_corr=num.to(torch.int32))

    return step


def map_sharding(mesh: Optional[DeviceMesh], axis: str = "mp") -> Sharding:
    """The map arrays' sharding: row blocks over ``axis``."""
    return Sharding(mesh, (axis,))
