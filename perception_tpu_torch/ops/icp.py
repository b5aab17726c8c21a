"""Point-to-plane Iterative Closest Point by Gauss-Newton.

Counterpart of ``perception_tpu/ops/icp.py``'s ``icp_point_to_plane``,
with the restart/batch dimension written out: R source clouds are
aligned to one target at once. ``icp_point_to_point`` and
``icp_batched`` are later work (ROADMAP.md, Queue 2).

The JAX package's vmapped ``lax.while_loop`` becomes a fixed
``max_iterations`` trip count in which each lane's transform, iteration
count and ``done`` flag freeze once it is done — what the vmapped loop
computes. The loop body never reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops.points import apply_mask


class ICPResult(NamedTuple):
    transform: torch.Tensor   # (..., 4, 4) source -> target
    fitness: torch.Tensor     # (...,) mean squared correspondence distance
    num_corr: torch.Tensor    # (...,) int32 gated correspondences at the end
    iterations: torch.Tensor  # (...,) int32
    converged: torch.Tensor   # (...,) bool — hit the epsilon (not the cap)


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss: 1 inside delta, delta/|r| outside."""
    absr = torch.abs(r)
    # A tensor numerator keeps this a true division (a Python float
    # over a tensor is a reciprocal multiply in torch).
    delta_t = const(delta, r)
    return torch.where(absr <= delta_t, torch.ones_like(r), delta_t / torch.clamp(absr, min=1e-12))


def icp_point_to_plane(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_normals: torch.Tensor,
    target_mask: torch.Tensor,
    init_transform: Optional[torch.Tensor] = None,
    max_iterations: int = 20,
    transformation_epsilon: float = 1e-10,
    max_correspondence_distance: float = 1.0e5,
    huber_delta: float = 0.02,
    damping: float = 1e-6,
    nn_tile: int = 4096,
) -> ICPResult:
    """Point-to-plane ICP of sources (..., N, 3) against one target (M, 3).

    Residual r_i = n_i . (T p_i - q_i) with q/n the NN target point and
    normal; each iteration solves the damped, Huber-weighted 6x6 normal
    equations and updates T <- exp(xi) T. ``init_transform`` is
    (..., 4, 4) or None (identity).
    """
    batch = source.shape[:-2]
    dev, dt = source.device, source.dtype
    if init_transform is None:
        T = torch.eye(4, dtype=dt, device=dev).expand(batch + (4, 4))
    else:
        T = init_transform.to(dt).expand(batch + (4, 4))
    source = apply_mask(source, source_mask)
    max_d2 = max_correspondence_distance * max_correspondence_distance
    damp = damping * torch.eye(6, dtype=dt, device=dev)
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    for _ in range(max_iterations):
        src_t = se3.transform_points(T, source)
        idx, d2 = _nn.nearest_neighbor(src_t, target, target_mask, tile=nn_tile)
        q = target[idx]
        n = target_normals[idx]
        gate = source_mask & (d2 <= max_d2)
        r = torch.sum(n * (src_t - q), dim=-1)
        w = gate.to(dt) * _huber_weight(r, huber_delta)
        J = torch.cat([n, torch.linalg.cross(src_t, n)], dim=-1)  # (..., N, 6)
        Jw = J * w[..., None]
        A = Jw.transpose(-1, -2) @ J + damp
        b = -(Jw.transpose(-1, -2) @ r[..., None])
        xi = torch.linalg.solve_ex(A, b)[0][..., 0]
        T_new = se3.se3_exp(xi) @ T
        small = torch.sum(xi * xi, dim=-1) < transformation_epsilon
        active = ~done
        T = torch.where(active[..., None, None], T_new, T)
        it = it + active.to(torch.int32)
        done = done | small

    src_t = se3.transform_points(T, source)
    _, d2 = _nn.nearest_neighbor(src_t, target, target_mask, tile=nn_tile)
    gate = source_mask & (d2 <= max_d2)
    w = gate.to(dt)
    fitness = torch.sum(d2 * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return ICPResult(
        transform=T,
        fitness=fitness,
        num_corr=torch.sum(gate, dim=-1, dtype=torch.int32),
        iterations=it,
        converged=done,
    )
