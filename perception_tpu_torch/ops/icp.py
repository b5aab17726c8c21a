"""Iterative Closest Point: point-to-point (SVD) and point-to-plane (GN).

Counterpart of ``perception_tpu/ops/icp.py``, with the restart/batch
dimension written out: a batch of source clouds is aligned at once, to
one target or to one target per batch row.

The JAX package's vmapped ``lax.while_loop`` becomes a trip count in
which each lane's transform, iteration count and ``done`` flag freeze
once it is done — what the vmapped loop computes. Point-to-plane runs
all ``max_iterations`` trips and never reads a value back to the host.
Point-to-point reads ``done.all()`` after every ``DONE_CHECK_EVERY``
trips and stops once every lane is done (the frozen lanes make the
result the same), and each trip's batched 3x3 ``torch.linalg.svd``
waits for the card inside the library on CUDA (two syncs a call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops.points import apply_mask

DONE_CHECK_EVERY = 10  # point-to-point trips between host reads of done.all()


class ICPResult(NamedTuple):
    transform: torch.Tensor   # (..., 4, 4) source -> target
    fitness: torch.Tensor     # (...,) mean squared correspondence distance
    num_corr: torch.Tensor    # (...,) int32 gated correspondences at the end
    iterations: torch.Tensor  # (...,) int32
    converged: torch.Tensor   # (...,) bool — hit the epsilon (not the cap)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LU, no host sync)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _umeyama(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment src -> tgt (Kabsch/Umeyama, no scale):
    (..., N, 3), (..., N, 3), (..., N) -> (..., 4, 4). The last singular
    pair is flipped when the SVD's rotation would be a reflection."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)[..., None]
    cs = torch.sum(src * w[..., None], dim=-2) / wsum
    ct = torch.sum(tgt * w[..., None], dim=-2) / wsum
    H = ((src - cs[..., None, :]) * w[..., None]).transpose(-1, -2) @ (tgt - ct[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = _det3(V @ Ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = V @ D @ Ut
    t = ct - (R @ cs[..., None])[..., 0]
    return se3.make_T(R, t)


def icp_point_to_point(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    init_transform: Optional[torch.Tensor] = None,
    max_iterations: int = 50,
    transformation_epsilon: float = 1e-9,
    euclidean_fitness_epsilon: float = 0.0,
    max_correspondence_distance: float = 1.0e5,
    nn_tile: int = 4096,
) -> ICPResult:
    """Point-to-point ICP of sources (..., N, 3) against a target (M, 3)
    (or one per batch row, (..., M, 3)) by a weighted SVD alignment per
    iteration. A lane stops when its increment's squared twist norm is
    under ``transformation_epsilon`` or its fitness changed by less than
    ``euclidean_fitness_epsilon`` (PCL's criteria), or at the cap."""
    batch = source.shape[:-2]
    dev, dt = source.device, source.dtype
    if init_transform is None:
        T = torch.eye(4, dtype=dt, device=dev).expand(batch + (4, 4))
    else:
        T = init_transform.to(dt).expand(batch + (4, 4))
    source = apply_mask(source, source_mask)
    max_d2 = max_correspondence_distance * max_correspondence_distance
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    prev_fit = torch.full(batch, float("inf"), dtype=dt, device=dev)

    for trip in range(1, max_iterations + 1):
        src_t = se3.transform_points(T, source)
        idx, d2 = _nn.nearest_neighbor(src_t, target, target_mask, tile=nn_tile)
        w = (source_mask & (d2 <= max_d2)).to(dt)
        delta = _umeyama(src_t, _nn.gather_rows(target, idx), w)
        fit = torch.sum(d2 * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
        twist = se3.se3_log(delta)
        small = (torch.sum(twist * twist, dim=-1) < transformation_epsilon) | (
            torch.abs(prev_fit - fit) < euclidean_fitness_epsilon)
        active = ~done
        T = torch.where(active[..., None, None], delta @ T, T)
        prev_fit = torch.where(active, fit, prev_fit)
        it = it + active.to(torch.int32)
        done = done | small
        if trip % DONE_CHECK_EVERY == 0 and trip < max_iterations and bool(done.all()):
            break

    return _final_stats(T, source, source_mask, target, target_mask, max_d2, nn_tile, it, done)


def _final_stats(T, source, source_mask, target, target_mask, max_d2, nn_tile, it, done) -> ICPResult:
    """Fitness and gated correspondences against the final transforms."""
    src_t = se3.transform_points(T, source)
    _, d2 = _nn.nearest_neighbor(src_t, target, target_mask, tile=nn_tile)
    gate = source_mask & (d2 <= max_d2)
    w = gate.to(source.dtype)
    fitness = torch.sum(d2 * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return ICPResult(
        transform=T,
        fitness=fitness,
        num_corr=torch.sum(gate, dim=-1, dtype=torch.int32),
        iterations=it,
        converged=done,
    )


def icp_batched(
    sources: torch.Tensor,
    source_masks: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    init_transforms: Optional[torch.Tensor] = None,
    **kwargs,
) -> ICPResult:
    """Point-to-point ICP of B source clouds (B, N, 3) against one target:
    the JAX package's vmap, as one batch of lanes."""
    return icp_point_to_point(sources, source_masks, target, target_mask, init_transforms, **kwargs)


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
    """Point-to-plane ICP of sources (..., N, 3) against one target (M, 3)
    with normals (M, 3), or one per batch row ((..., M, 3), (..., M)).

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
        q = _nn.gather_rows(target, idx)
        n = _nn.gather_rows(target_normals, idx)
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

    return _final_stats(T, source, source_mask, target, target_mask, max_d2, nn_tile, it, done)
