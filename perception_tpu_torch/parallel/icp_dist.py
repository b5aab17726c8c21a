"""Distributed point-to-plane ICP / Gauss-Newton over a (dp, sp) mesh.

Counterpart of ``perception_tpu/parallel/icp_dist.py``. A batch of frames
is split over ``dp`` and each frame's points over ``sp``; each rank holds
its (B/dp, N/sp) block. One GN iteration:

1. each rank finds its points' neighbours in the replicated map
   (``ops/nn.nearest_neighbor``);
2. it sums its points' share of each frame's 6x6 normal equations A, b,
   the summed absolute residual and the gated count;
3. one ``all_reduce`` over ``sp`` of all its frames' (A, b, residual,
   count) completes every frame's system (JAX's ``psum`` over ``sp``);
4. the damped 6x6 solve and the SE(3) update run on every rank of the
   ``sp`` group alike.

After the last iteration one ``all_reduce`` over ``dp`` sums the fleet's
residual and count. The diagnostics are the last iteration's, measured
before its update, as JAX's scan carries them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops.icp import _huber_weight
from perception_tpu_torch.parallel.mesh import all_reduce, group


class DistICPResult(NamedTuple):
    transforms: torch.Tensor     # (B/dp, 4, 4) this rank's frames' refined poses
    mean_residual: torch.Tensor  # () fleet mean |r| over gated correspondences
    num_corr: torch.Tensor       # () int32 fleet total of gated correspondences


def make_distributed_icp_step(
    mesh: Optional[DeviceMesh],
    iterations: int = 8,
    max_correspondence_distance: float = 0.5,
    huber_delta: float = 0.02,
    damping: float = 1e-6,
):
    """The ICP step of one rank of ``mesh``:
    ``step(frames, masks, init_T, target, target_normals, target_mask)``
    with this rank's frames (B/dp, N/sp, 3) and masks (B/dp, N/sp), their
    initial poses (B/dp, 4, 4), and the whole map (M, 3), its normals and
    mask. Returns this rank's transforms and the fleet's diagnostics, the
    same on every rank. ``mesh=None`` runs one rank holding every frame
    and point: the single-rank reference. (The JAX function returns one
    jitted step over the global arrays.)"""
    max_d2 = max_correspondence_distance * max_correspondence_distance
    sp, dp = group(mesh, "sp"), group(mesh, "dp")

    def step(frames, masks, init_T, target, target_normals, target_mask) -> DistICPResult:
        eye = damping * torch.eye(6, device=frames.device)
        T = init_T
        for _ in range(iterations):
            src_t = se3.transform_points(T, frames)
            idx, d2 = _nn.nearest_neighbor(src_t, target, target_mask)
            q = _nn.gather_rows(target, idx)
            n = _nn.gather_rows(target_normals, idx)
            gate = masks & (d2 <= max_d2)
            r = torch.sum(n * (src_t - q), dim=-1)
            w = gate.to(frames.dtype) * _huber_weight(r, huber_delta)
            J = torch.cat([n, torch.cross(src_t, n, dim=-1)], dim=-1)
            Jw = J * w[..., None]
            A, g, res, cnt = all_reduce([Jw.transpose(1, 2) @ J, -(Jw.transpose(1, 2) @ r[..., None])[..., 0],
                                         torch.sum(torch.abs(r) * gate, dim=-1),
                                         torch.sum(gate, dim=-1, dtype=torch.int32)], sp)
            xi = torch.linalg.solve_ex(A + eye, g[..., None])[0][..., 0]
            T = se3.se3_exp(xi) @ T
        res_tot, cnt_tot = all_reduce([res.sum(), cnt.sum()], dp)
        cnt_tot = cnt_tot.to(torch.int32)
        mean_res = res_tot / torch.clamp(cnt_tot.to(res_tot.dtype), min=1.0)
        return DistICPResult(transforms=T, mean_residual=mean_res, num_corr=cnt_tot)

    return step
