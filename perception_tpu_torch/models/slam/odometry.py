"""Frame-to-keyframe point-to-plane ICP odometry (the SLAM front end).

Counterpart of ``perception_tpu/models/slam/odometry.py``. Every frame is
backprojected, given depth-image normals and grid-stride subsampled to a
fixed point budget; Gauss-Newton point-to-plane ICP, warm-started from
the previous pose, aligns it to the current keyframe cloud (keyframe
mode) or to a voxel-fused local map of recent keyframes (map mode,
``map_budget > 0``); a keyframe is promoted when the motion to it or
the correspondence overlap passes a threshold.

Engines, as ``OdometryConfig`` selects them:

- keyframe mode, ``fused_gn`` "auto"/"off": the op graph with brute NN
  (``ops/nn.py``); "on": the fused GN kernel K2
  (``ops/kernels/icp_gn.py``) once per iteration, the whole loop
  replayed on the card as one CUDA graph (``_GNGraph``);
- map mode, ``map_nn`` "auto"/"shortlist": one top-k NN pass per frame,
  then k-candidate argmins and an exact brute polish; "brute": brute NN
  every iteration; "hash": the persistent voxel hash
  (``ops/voxelhash.py``, kernel K3+K4) once per iteration and once for
  the final stats.

The JAX package jits the whole step. Here it runs eagerly, but for that
one graph: ``lax.scan``
is a Python loop, ``lax.approx_max_k`` is ``torch.topk`` (exact, as
JAX's is on the CPU), and the ``lax.cond`` that fuses the map on a
promotion is a Python ``if`` on one host read of ``promote`` per frame,
in map mode only. Nothing inside the Gauss-Newton iterations reads back
to the host, and keyframe mode never does. The large products
``torch.matmul`` computes are the brute-NN distance products (keyframe
mode, map mode's "brute"), which the JAX package also leaves to XLA; the
other ``@`` are 6x6 normal equations and 4x4 poses. Map mode forms its
warm start, posed points and the shortlist engine's distances (the
shortlist and the brute polish) from explicit products added in a fixed
order (``_relative``, ``_posed``, ``_shortlist_d2``), and orders the
shortlist's ties by index (``_k_smallest``): from the same state the
card and the CPU pick the same candidates and nearest points, where 4x4
and K=3 matmuls round differently on each. The Gauss-Newton sums
(``_gn_update``'s 6 x N products) still do, so whole runs part by
rounding.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple, Tuple

import torch

from perception_tpu_torch._tensor import const, fp32
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops import voxelhash
from perception_tpu_torch.ops.icp import _huber_weight
from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed, pack_source, pack_target
from perception_tpu_torch.ops.normals import normals_from_depth
from perception_tpu_torch.ops.points import (
    SENTINEL,
    apply_mask,
    compact_with_attrs,
    voxel_downsample_with_attrs,
)
from perception_tpu_torch.utils.profiler import count_launch, span, tallied

SHORTLIST_TILE = 4096  # map columns of the shortlist's distance matrix built at a time


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """The JAX package's fields and defaults; its docstrings carry the
    measurements behind each default."""

    point_budget: int = 4096          # per-frame ICP source points
    keyframe_budget: int = 8192       # keyframe target cloud capacity
    icp_iterations: int = 10
    max_correspondence_distance: float = 0.25
    huber_delta: float = 0.02
    damping: float = 1e-5
    min_depth: float = 0.2
    max_depth: float = 5.0
    normal_max_edge: float = 0.05     # tangent-length discontinuity gate (m)
    fused_gn: str = "auto"            # "auto"/"off": op graph; "on": kernel K2
    # Dense local-map fusion mode (map_budget > 0).
    map_budget: int = 0               # 0 = keyframe-target mode
    map_voxel: float = 0.02           # fusion dedup leaf (m)
    map_decay: float = 1.0            # weight of surviving map points per fuse
    map_nn_radius: float = 0.06       # correspondence radius in map mode
    map_nn: str = "auto"              # "auto"/"shortlist", "brute", "hash"
    map_nn_shortlist: int = 16        # candidates per point (shortlist)
    map_nn_polish: int = 2            # final iterations with full brute NN
    map_nn_refresh: int = 1           # shortlist builds per frame
    map_nn_coarse: int = 1            # source stride of the shortlisted iterations
    map_nn_recall: float = 0.99       # >= 1.0: exact segmented argmin shortlist
    # Keyframe promotion thresholds.
    kf_translation: float = 0.15      # metres
    kf_rotation: float = 0.2          # radians
    kf_min_overlap: float = 0.5       # gated-correspondence fraction


class OdometryState(NamedTuple):
    pose: torch.Tensor           # (4, 4) world <- camera (current frame)
    kf_pose: torch.Tensor        # (4, 4) world <- keyframe camera
    kf_points: torch.Tensor      # (Mk, 3) keyframe cloud, keyframe camera frame
    kf_normals: torch.Tensor     # (Mk, 3)
    kf_mask: torch.Tensor        # (Mk,)
    frame_index: torch.Tensor    # () int32
    num_keyframes: torch.Tensor  # () int32
    # Local fused map in the current keyframe's frame (map mode;
    # zero-capacity otherwise).
    map_points: torch.Tensor     # (Mb, 3)
    map_normals: torch.Tensor    # (Mb, 3)
    map_mask: torch.Tensor       # (Mb,)
    # Cell-sorted hash of the map, rebuilt only on promotion (hash
    # engine; a one-row placeholder otherwise).
    map_hash: voxelhash.VoxelHash
    map_nrm_hash: torch.Tensor   # (Mb, 3) normals in hash order


class OdometryDiag(NamedTuple):
    fitness: torch.Tensor      # () mean squared correspondence distance
    overlap: torch.Tensor      # () gated-correspondence fraction
    promoted: torch.Tensor     # () bool: this frame became a keyframe
    num_corr: torch.Tensor     # () int32
    nn_overflow: torch.Tensor  # () hash range-overflow / shortlist-miss
                               # fraction of the final pass (0 on brute/fused)


def _subsample_indices(n: int, budget: int, phase, device):
    """Grid-stride subsample with a per-frame phase jitter (phase mod
    stride), so structured scenes do not alias onto the same columns."""
    stride = max(n // budget, 1)
    offset = torch.as_tensor(phase, device=device) % stride
    return torch.clamp(torch.arange(budget, device=device) * stride + offset, 0, n - 1)


def _frame_features(camera: PinholeCamera, depth, cfg: OdometryConfig, phase=0):
    """Backproject + normals + subsample one depth image:
    (src_pts, src_mask, kf_pts, kf_norm, kf_mask)."""
    with span("odometry.frame_features"):
        pts_flat, valid_flat = camera.backproject_depth(
            depth, min_depth=cfg.min_depth, max_depth=cfg.max_depth
        )
        h, w = depth.shape
        normals, nvalid = normals_from_depth(
            pts_flat.reshape(h, w, 3), valid_flat.reshape(h, w), max_edge=cfg.normal_max_edge
        )
        normals = normals.reshape(-1, 3)
        good = valid_flat & nvalid.reshape(-1)

        src_idx = _subsample_indices(h * w, cfg.point_budget, phase, depth.device)
        kf_idx = _subsample_indices(h * w, cfg.keyframe_budget, phase, depth.device)
        return pts_flat[src_idx], good[src_idx], pts_flat[kf_idx], normals[kf_idx], good[kf_idx]


def _fuse_map(map_pts, map_nrm, map_mask, kf_pts, kf_norm, kf_mask, cfg: OdometryConfig):
    """Merge a keyframe cloud into the local map (all in the new
    keyframe's frame): concatenate, voxel-dedup at ``map_voxel``
    (centroids, renormalised mean normals), decimate to ``map_budget``.
    With ``map_decay`` != 1 surviving map points enter each voxel at that
    weight and the keyframe's at 1."""
    pts = torch.cat([map_pts, kf_pts])
    nrm = torch.cat([map_nrm, kf_norm])
    msk = torch.cat([map_mask, kf_mask])
    weights = None
    if cfg.map_decay != 1.0:
        weights = torch.cat([torch.full_like(map_pts[:, 0], cfg.map_decay),
                             torch.ones_like(kf_pts[:, 0])])
    fused_pts, fused_nrm, fused_mask = voxel_downsample_with_attrs(
        pts, msk, nrm, cfg.map_voxel, weights=weights
    )
    norm = torch.linalg.vector_norm(fused_nrm, dim=-1, keepdim=True)
    fused_nrm = fused_nrm / torch.clamp(norm, min=1e-9)
    # Opposed normals can cancel in a voxel; drop those points.
    fused_mask = fused_mask & (norm[:, 0] > 0.2)
    return compact_with_attrs(fused_pts, fused_mask, fused_nrm, cfg.map_budget)


def _map_engine(cfg: OdometryConfig) -> str:
    """The map-mode NN engine; "auto" is the shortlist (the JAX package's
    measured default)."""
    if cfg.map_nn in ("shortlist", "brute", "hash"):
        return cfg.map_nn
    return "shortlist"


def _use_hash(cfg: OdometryConfig) -> bool:
    return cfg.map_budget > 0 and _map_engine(cfg) == "hash"


def _build_map_hash(map_pts, map_nrm, map_mask, cfg: OdometryConfig):
    vh = voxelhash.build(map_pts, map_mask, cell_size=cfg.map_nn_radius)
    return vh, map_nrm[vh.order]


def _dummy_hash(device):
    """Placeholder for configs that never query the hash."""
    z3 = torch.zeros((1, 3), device=device)
    i1 = torch.zeros((1,), dtype=torch.int32, device=device)
    return (
        voxelhash.VoxelHash(
            points=z3,
            table=torch.zeros((1, 8), device=device),
            cell_ids=i1,
            origin=torch.zeros((3,), device=device),
            cell_size=torch.ones((), device=device),
            dims=torch.ones((3,), dtype=torch.int32, device=device),
            sentinel_id=torch.ones((), dtype=torch.int32, device=device),
            order=i1,
        ),
        z3,
    )


def _gn_update(T, src_t, q, nrm, gate, cfg: OdometryConfig):
    """One damped, Huber-weighted point-to-plane GN step: exp(xi) @ T."""
    r = torch.sum(nrm * (src_t - q), dim=-1)
    w = gate.to(src_t.dtype) * _huber_weight(r, cfg.huber_delta)
    J = torch.cat([nrm, torch.linalg.cross(src_t, nrm, dim=-1)], dim=-1)
    Jw = J * w[:, None]
    A = Jw.T @ J + cfg.damping * torch.eye(6, dtype=src_t.dtype, device=src_t.device)
    b = -(Jw.T @ r)
    xi = torch.linalg.solve_ex(A, b[:, None])[0][:, 0]
    return se3.se3_exp(xi) @ T


def init_state(camera: PinholeCamera, depth0: torch.Tensor,
               cfg: OdometryConfig = OdometryConfig()) -> OdometryState:
    """Bootstrap from the first frame (identity pose, first keyframe)."""
    dev = depth0.device
    _, _, kf_pts, kf_norm, kf_mask = _frame_features(camera, depth0, cfg)
    eye = torch.eye(4, device=dev)
    if cfg.map_budget > 0:
        mb = cfg.map_budget
        map_pts, map_nrm, map_mask = _fuse_map(
            torch.full((mb, 3), SENTINEL, device=dev), torch.zeros((mb, 3), device=dev),
            torch.zeros(mb, dtype=torch.bool, device=dev), kf_pts, kf_norm, kf_mask, cfg,
        )
    else:
        map_pts = torch.zeros((0, 3), device=dev)
        map_nrm = torch.zeros((0, 3), device=dev)
        map_mask = torch.zeros((0,), dtype=torch.bool, device=dev)
    if _use_hash(cfg):
        map_hash, map_nrm_hash = _build_map_hash(map_pts, map_nrm, map_mask, cfg)
    else:
        map_hash, map_nrm_hash = _dummy_hash(dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    return OdometryState(
        pose=eye,
        kf_pose=eye,
        kf_points=apply_mask(kf_pts, kf_mask),
        kf_normals=kf_norm,
        kf_mask=kf_mask,
        frame_index=one,
        num_keyframes=one,
        map_points=map_pts,
        map_normals=map_nrm,
        map_mask=map_mask,
        map_hash=map_hash,
        map_nrm_hash=map_nrm_hash,
    )


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 of (..., 3) rows: x, y and z squared and added left to right,
    each operation rounded alone, so every device gives the same bits (a
    ``torch.sum`` over the axis may pair the three otherwise)."""
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def _posed(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, 3) points under the (4, 4) pose ``T``: ``x R[:, 0] + y R[:, 1] +
    z R[:, 2] + t`` added left to right, each operation rounded alone.
    ``se3.transform_points`` is a K=3 ``torch.matmul``, which cuBLAS and the
    CPU's BLAS round differently; map mode's discrete choices (the
    shortlist, the nearest map point) see these coordinates."""
    R, t = T[:3, :3], T[:3, 3]
    return p[:, 0:1] * R[:, 0] + p[:, 1:2] * R[:, 1] + p[:, 2:3] * R[:, 2] + t


def _relative(kf_pose: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """``se3.inverse(kf_pose) @ pose``, the frame's warm start in the
    keyframe's frame, each entry's products added left to right: a 4x4
    matmul rounds otherwise on cuBLAS than on the CPU, and map mode's
    choices see the ulp."""
    Rt, t = kf_pose[:3, :3].T, kf_pose[:3, 3]
    inv = se3.make_T(Rt, -(Rt[:, 0] * t[0] + Rt[:, 1] * t[1] + Rt[:, 2] * t[2]))
    return inv[:, 0:1] * pose[0] + inv[:, 1:2] * pose[1] + inv[:, 2:3] * pose[2] + inv[:, 3:4] * pose[3]


def _shortlist_d2(src_t: torch.Tensor, map_masked: torch.Tensor, map_sq: torch.Tensor,
                  tile: int = SHORTLIST_TILE) -> torch.Tensor:
    """The shortlist's (Ns, M) squared distances ``|s|^2 - 2 s.m + |m|^2``
    (the form the ``nn_overflow`` tolerance is tuned to), ``map_sq`` from
    ``_sq_norm``. ``s.m`` is three products added x, y, z left to right,
    not a K=3 ``torch.matmul``: cuBLAS and the CPU's BLAS order and fuse
    that product differently, and against |s|^2 of 4-25 m^2 an ulp decides
    near-ties. Built a ``tile`` of map columns at a time, so the product
    temporaries stay (Ns, tile)."""
    s_sq = _sq_norm(src_t)[:, None]
    x, y, z = src_t[:, 0:1], src_t[:, 1:2], src_t[:, 2:3]
    d2 = src_t.new_empty((src_t.shape[0], map_masked.shape[0]))
    for c in range(0, map_masked.shape[0], tile):
        m = map_masked[c:c + tile]
        dot = x * m[:, 0] + y * m[:, 1] + z * m[:, 2]
        d2[:, c:c + tile] = s_sq - 2.0 * dot + map_sq[c:c + tile]
    return d2


def _k_smallest(d2: torch.Tensor, cols: torch.Tensor, k: int, m: int):
    """The k smallest of each row of ``d2`` in (value, column) order:
    (columns, values), ``cols`` each entry's column in [0, m). Exact, and
    the same on every device: each entry's key is its float's order as an
    integer (-0.0 equal to +0.0) times ``m`` plus its column, so no two
    keys tie and ``torch.topk`` of the keys has one answer; the values
    are decoded from the keys."""
    bits = d2.view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, -bits - 2**31, bits)
    key = torch.topk(order * m + cols, k, dim=1, largest=False).values
    col = torch.remainder(key, m)
    order = torch.div(key - col, m, rounding_mode="floor")
    bits = torch.where(order < 0, -order - 2**31, order)
    return col, bits.to(torch.int32).view(torch.float32)


def _nearest_k(d2: torch.Tensor, k: int):
    """The k smallest of each row of ``d2`` as (indices, values), in (value,
    index) order: equal distances lower index first, also at the k-th
    place, as the JAX package's ``approx_max_k`` gives them on the CPU (its
    exact fallback), so the shortlist holds the same points on every
    device and the shortlist's first-minimum argmin takes the same copy."""
    m = d2.shape[1]
    return _k_smallest(d2, torch.arange(m, device=d2.device), k, m)


def _shortlist_candidates(src_t, map_masked, map_sq, k: int, pad: int = 16):
    """``_nearest_k`` of the shortlist's distance matrix at less cost: a
    float ``torch.topk`` of k + ``pad``, whose candidates hold every
    distance under the k-th and, unless a row's ties of the k-th run past
    them, all its ties; the exact (value, index) order among those; and
    for rows whose ties do run past (a masked source point at the sentinel
    ties with many map points), the lowest-index ties from an int32
    ``torch.topk`` over the whole row."""
    d2 = _shortlist_d2(src_t, map_masked, map_sq)
    m = d2.shape[1]
    vals, idx = torch.topk(d2, min(k + pad, m), dim=1, largest=False)
    col, v = _k_smallest(vals, idx, k, m)
    kth = v[:, -1:]
    cols = torch.arange(m, device=d2.device, dtype=torch.int32)
    ties = torch.topk(torch.where(d2 == kth, cols, m), k, dim=1, largest=False).values.long()
    # The candidates under the k-th distance and the first ties; pads
    # (column m) at +inf are never among the k.
    merged = torch.cat([torch.where(v < kth, col, m), ties], dim=1)
    at = merged.clamp(max=m - 1)
    val = torch.where(merged < m, torch.gather(d2, 1, at), torch.full_like(kth, float("inf")))
    return torch.where(vals[:, -1:] == kth, _k_smallest(val, at, k, m)[0], col)


def _build_shortlist(src_t, map_masked, map_sq, map_points, cfg: OdometryConfig):
    """Each posed source point's ``map_nn_shortlist`` candidates: (indices
    (Ns, k), their map points (Ns, k, 3))."""
    k = cfg.map_nn_shortlist
    if cfg.map_nn_recall >= 1.0:
        # Exact segmented argmin: each of k map segments gives its winner.
        d2_full = _shortlist_d2(src_t, map_masked, map_sq)
        m = d2_full.shape[1]
        d2p = torch.nn.functional.pad(d2_full, (0, (-m) % k), value=float("inf"))
        seg = d2p.reshape(d2p.shape[0], k, -1)
        ci = torch.argmin(seg, dim=2) + torch.arange(k, device=seg.device)[None] * seg.shape[2]
        ci = torch.clamp(ci, max=m - 1)
    else:
        ci = _shortlist_candidates(src_t, map_masked, map_sq, k)
    return ci, map_points[ci]


def _map_nearest(src_t, map_masked, map_sq, tile: int = SHORTLIST_TILE):
    """Brute NN over the masked map in the shortlist's distance form, a
    ``tile`` of map rows at a time: (index, squared distance clamped at 0),
    the first of equal minima (``nn.nearest_neighbor``'s answer, in the
    fixed-order form)."""
    best_d2 = best_idx = None
    for c in range(0, map_masked.shape[0], tile):
        d2, i = torch.min(_shortlist_d2(src_t, map_masked[c:c + tile], map_sq[c:c + tile], tile), dim=1)
        if best_d2 is None:
            best_d2, best_idx = d2, i
        else:
            take = d2 < best_d2
            best_d2, best_idx = torch.where(take, d2, best_d2), torch.where(take, i + c, best_idx)
    return best_idx, torch.clamp(best_d2, min=0.0)


def _shortlist_nn(src_t, cand_idx, cand_pts):
    """Each posed source point's nearest of its candidates: (map index,
    squared distance), the first of equal minima."""
    diff = src_t[:, None, :] - cand_pts
    d2k = _sq_norm(diff)
    j = torch.argmin(d2k, dim=1, keepdim=True)
    return torch.gather(cand_idx, 1, j)[:, 0], torch.gather(d2k, 1, j)[:, 0]


def _track_map(state: OdometryState, src_pts, src_mask, T0, cfg: OdometryConfig):
    """Map mode: GN against the fused map with the configured engine.
    Returns (T, num_corr, fitness, nn_overflow, src_mask)."""
    engine = _map_engine(cfg)
    r2 = cfg.map_nn_radius**2
    zero = torch.zeros((), device=src_pts.device)

    def gn_iter(T, query_fn, pts, mask, map_pts_nn, nrm_sorted):
        src_t = _posed(T, pts)
        idx, d2 = query_fn(src_t)
        gate = mask & (d2 <= r2)
        return _gn_update(T, src_t, map_pts_nn[idx], nrm_sorted[idx], gate, cfg)

    if engine == "shortlist":
        # One top-k pass under the warm start; each fast iteration then
        # argmins over its k candidates, and the exact brute polish ends
        # the solve (stats from its last iteration, one iteration stale).
        map_masked = apply_mask(state.map_points, state.map_mask)
        map_sq = _sq_norm(map_masked)
        stride = max(cfg.map_nn_coarse, 1)
        src_fast, mask_fast = src_pts[::stride], src_mask[::stride]

        def build_shortlist(T):
            return _build_shortlist(_posed(T, src_fast), map_masked, map_sq, state.map_points, cfg)

        def shortlist_query(cand_idx, cand_pts):
            return lambda src_t: _shortlist_nn(src_t, cand_idx, cand_pts)

        nn_query = shortlist_query(*build_shortlist(T0))
        polish = max(cfg.map_nn_polish, 1)
        n_fast = max(cfg.icp_iterations - polish, 0)
        refresh = max(cfg.map_nn_refresh, 1)
        per = [n_fast // refresh] * refresh
        per[-1] += n_fast - sum(per)
        T = T0
        for s, length in enumerate(per):
            q = nn_query if s == 0 else shortlist_query(*build_shortlist(T))
            for _ in range(length):
                T = gn_iter(T, q, src_fast, mask_fast, state.map_points, state.map_normals)

        n_fast_valid = torch.clamp(torch.sum(mask_fast), min=1).to(torch.float32)
        gd2 = nn_overflow = zero
        num_corr = torch.zeros((), dtype=torch.int32, device=zero.device)
        for _ in range(polish):
            src_t = _posed(T, src_pts)
            idx, d2 = _map_nearest(src_t, map_masked, map_sq)
            gate = src_mask & (d2 <= r2)
            # Shortlist-miss fraction at the pose the brute pass saw; the
            # tolerance sits above the two formulas' f32 difference.
            _, d2s = nn_query(src_t[::stride])
            d2b = d2[::stride]
            nn_overflow = torch.sum((d2s - d2b > 1e-5 + 1e-3 * d2b) & mask_fast) / n_fast_valid
            gd2 = torch.sum(torch.where(gate, d2, 0.0))
            num_corr = torch.sum(gate, dtype=torch.int32)
            T = _gn_update(T, src_t, state.map_points[idx], state.map_normals[idx], gate, cfg)
        fitness = gd2 / torch.clamp(num_corr.to(torch.float32), min=1.0)
        return T, num_corr, fitness, nn_overflow, src_mask

    if engine == "hash":
        # The cell sort of the map was paid at the last promotion. The
        # source is sorted into cell order once per frame, under the warm
        # start; the iterations keep that order (sort=False), and sums are
        # permutation-invariant, so the sorted copies replace the source.
        vh = state.map_hash
        map_pts_nn, nrm_sorted = vh.points, state.map_nrm_hash
        with span("odometry.map_sort"):
            _, src_order = voxelhash.sort_by_cell(vh, se3.transform_points(T0, src_pts))
            src_pts, src_mask = src_pts[src_order], src_mask[src_order]

        def nn_query(src_t):
            return voxelhash.query(vh, src_t, sort=False)

        def nn_query_stats(src_t):
            return voxelhash.query(vh, src_t, sort=False, return_stats=True)
    else:
        map_pts_nn, nrm_sorted = apply_mask(state.map_points, state.map_mask), state.map_normals

        def nn_query(src_t):
            return _nn.nearest_neighbor(src_t, map_pts_nn, state.map_mask)

        def nn_query_stats(src_t):
            return (*nn_query(src_t), zero)

    T = T0
    for _ in range(cfg.icp_iterations):
        T = gn_iter(T, nn_query, src_pts, src_mask, map_pts_nn, nrm_sorted)
    _, d2, nn_overflow = nn_query_stats(se3.transform_points(T, src_pts))
    gate = src_mask & (d2 <= r2)
    num_corr = torch.sum(gate, dtype=torch.int32)
    fitness = torch.sum(torch.where(gate, d2, 0.0)) / torch.clamp(num_corr.to(torch.float32), min=1.0)
    return T, num_corr, fitness, nn_overflow, src_mask


def _fused_gn(src_pts, src_mask, kf_points, kf_normals, kf_mask, T, cfg: OdometryConfig):
    """Keyframe mode's GN loop on K2: (T, num_corr, fitness). Operands
    packed once; each iteration passes only the pose. The stats describe
    the start of the final iteration, as in the JAX package (one iteration
    stale, equal at convergence). Nothing reads back to the host and the
    config fixes every shape, so on the card ``_GNGraph`` captures it."""
    src8 = pack_source(src_pts[None], src_mask[None])
    tgtd, tnrm8 = pack_target(kf_points, kf_normals, kf_mask)
    eye6 = cfg.damping * torch.eye(6, device=T.device)
    ngate = gd2 = torch.zeros((), device=T.device)
    for _ in range(cfg.icp_iterations):
        M, stats = gn_system_packed(src8, tgtd, tnrm8, T[None], cfg.max_correspondence_distance,
                                    cfg.huber_delta, return_stats=True)
        xi = torch.linalg.solve_ex(M[0, :6, :6] + eye6, -M[0, :6, 6:7])[0][:, 0]
        T = se3.se3_exp(xi) @ T
        ngate, gd2 = stats[0, 0], stats[0, 1]
    return T, ngate.to(torch.int32), gd2 / torch.clamp(ngate, min=1.0)


class _GNGraph:
    """``_fused_gn`` captured once as a CUDA graph at one key: static
    inputs that each call's tensors are copied into, and static outputs
    that each replay overwrites and that leave only as clones, so no
    returned tensor aliases the next replay's. The replay runs the
    captured kernels with the eager loop's launch plans, in its order, so
    its results equal the eager loop's bit for bit. The launches that
    ``count_launch`` saw during the capture (``tally``) are counted again
    at each replay. One graph serves one thread at a time: two threads
    sharing a key would share its buffers."""

    def __init__(self, inputs, cfg: OdometryConfig):
        self.inputs = [torch.empty_like(t) for t in inputs]
        self.device = inputs[0].device
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls meanwhile are not the capture's concern.
        with torch.cuda.device(self.device), tallied() as self.tally, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.outputs = _fused_gn(*self.inputs, cfg)
        # The (1, Np, Mp) the capture launched K2 at; raises if it launched none.
        (self.shape,) = {shape for wrapper, shape in self.tally if wrapper is gn_system_packed}

    def __call__(self, inputs):
        with torch.cuda.device(self.device):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
            for (wrapper, shape), n in self.tally.items():
                count_launch(wrapper, shape, n)
            return tuple(t.clone() for t in self.outputs)


_GN_GRAPHS = {}  # _gn_key -> _GNGraph


def _gn_key(inputs, cfg: OdometryConfig):
    """What a captured ``_fused_gn`` depends on: the device, the operands'
    shapes, the loop's numbers and the TF32 flags its products ran under."""
    return (inputs[0].device, tuple(tuple(t.shape) for t in inputs), cfg.icp_iterations,
            cfg.max_correspondence_distance, cfg.huber_delta, cfg.damping,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _track_keyframe(state: OdometryState, src_pts, src_mask, T0, cfg: OdometryConfig):
    """Keyframe mode: GN against the keyframe cloud, through K2 when
    ``fused_gn == "on"``. Returns (T, num_corr, fitness).

    On CUDA tensors the fused loop's first call at a key runs eagerly and
    then captures the loop (``_track_keyframe.captures``, by the (1, Np,
    Mp) the capture launched K2 at); later calls replay the capture
    (``_track_keyframe.replays``), each counting the K2 launches its
    capture recorded. CPU tensors run it eagerly."""
    if cfg.fused_gn == "on":
        inputs = (src_pts, src_mask, state.kf_points, state.kf_normals, state.kf_mask, T0)
        if src_pts.device.type != "cuda":
            return _fused_gn(*inputs, cfg)
        key = _gn_key(inputs, cfg)
        graph = _GN_GRAPHS.get(key)
        if graph is None:
            out = _fused_gn(*inputs, cfg)
            _GN_GRAPHS[key] = graph = _GNGraph(inputs, cfg)
            _track_keyframe.captures[graph.shape] += 1
            return out
        out = graph(inputs)
        _track_keyframe.replays[graph.shape] += 1
        return out

    max_d2 = cfg.max_correspondence_distance**2

    def correspondences(T):
        src_t = se3.transform_points(T, src_pts)
        idx, d2 = _nn.nearest_neighbor(src_t, state.kf_points, state.kf_mask)
        return src_t, idx, d2, src_mask & (d2 <= max_d2)

    T = T0
    for _ in range(cfg.icp_iterations):
        src_t, idx, _, gate = correspondences(T)
        T = _gn_update(T, src_t, state.kf_points[idx], state.kf_normals[idx], gate, cfg)
    _, _, d2, gate = correspondences(T)
    num_corr = torch.sum(gate, dtype=torch.int32)
    return T, num_corr, torch.sum(d2 * gate) / torch.clamp(num_corr.to(d2.dtype), min=1.0)


_track_keyframe.captures = Counter()  # fused loops captured, by the (1, Np, Mp) K2 was captured at
_track_keyframe.replays = Counter()   # and replayed

# Map mode's updates on the host since import, beside K3+K4's
# ``voxelhash_query.launches``: "fuses" (promotions fused into the map by
# ``odometry_step``) and "hash_builds" (hash rebuilds after them).
map_updates = Counter()


@fp32()
def odometry_step(
    state: OdometryState,
    depth: torch.Tensor,
    camera: PinholeCamera,
    cfg: OdometryConfig = OdometryConfig(),
) -> Tuple[OdometryState, OdometryDiag]:
    """Track one frame; returns (new_state, diagnostics).

    In map mode the step reads ``promote`` to the host once, to decide
    whether to fuse the keyframe into the map (the JAX package's
    ``lax.cond``); nothing else in the step waits for the card."""
    with span("odometry.step"):
        src_pts, src_mask, new_kf_pts, new_kf_norm, new_kf_mask = _frame_features(
            camera, depth, cfg, phase=state.frame_index * 97
        )
        src_pts = apply_mask(src_pts, src_mask)

        # ICP in the keyframe's camera frame, from the previous pose.
        T0 = _relative(state.kf_pose, state.pose)
        if cfg.map_budget > 0:
            with span("odometry.track_map"):
                T, num_corr, fitness, nn_overflow, src_mask = _track_map(state, src_pts, src_mask, T0, cfg)
        else:
            with span("odometry.track_keyframe"):
                T, num_corr, fitness = _track_keyframe(state, src_pts, src_mask, T0, cfg)
                nn_overflow = torch.zeros((), device=T.device)  # brute and fused scan the full cloud

        with span("odometry.promote"):
            denom = torch.clamp(torch.sum(src_mask, dtype=torch.int32), min=1)
            overlap = num_corr.to(torch.float32) / denom.to(torch.float32)

            # Back onto SE(3): the inverse(kf_pose) @ pose warm start doubles any
            # off-manifold drift per frame.
            new_pose = se3.orthonormalize_T(state.kf_pose @ T)

            delta = se3.se3_log(T)
            promote = (
                (torch.linalg.vector_norm(delta[:3]) > cfg.kf_translation)
                | (torch.linalg.vector_norm(delta[3:]) > cfg.kf_rotation)
                | (overlap < cfg.kf_min_overlap)
            )

            map_pts, map_nrm, map_mask = state.map_points, state.map_normals, state.map_mask
            map_hash, map_nrm_hash = state.map_hash, state.map_nrm_hash
            fuse = False
            if cfg.map_budget > 0:
                # The step's one wait for the card: the device drains here.
                with span("odometry.map_promote_read"):
                    fuse = bool(promote)
            if fuse:
                # The map re-anchors to the new keyframe and absorbs its cloud;
                # with the hash engine this is the only place the hash is rebuilt.
                with span("odometry.map_fuse"):
                    inv_T = se3.inverse(T)
                    map_pts, map_nrm, map_mask = _fuse_map(
                        se3.transform_points(inv_T, state.map_points),
                        se3.rotate_points(inv_T, state.map_normals),
                        state.map_mask,
                        apply_mask(new_kf_pts, new_kf_mask),
                        new_kf_norm,
                        new_kf_mask,
                        cfg,
                    )
                    map_updates["fuses"] += 1
                    if _use_hash(cfg):
                        with span("odometry.map_hash_build"):
                            map_hash, map_nrm_hash = _build_map_hash(map_pts, map_nrm, map_mask, cfg)
                        map_updates["hash_builds"] += 1

            new_state = OdometryState(
                pose=new_pose,
                kf_pose=torch.where(promote, new_pose, state.kf_pose),
                kf_points=torch.where(promote, apply_mask(new_kf_pts, new_kf_mask), state.kf_points),
                kf_normals=torch.where(promote, new_kf_norm, state.kf_normals),
                kf_mask=torch.where(promote, new_kf_mask, state.kf_mask),
                frame_index=state.frame_index + 1,
                num_keyframes=state.num_keyframes + promote.to(torch.int32),
                map_points=map_pts,
                map_normals=map_nrm,
                map_mask=map_mask,
                map_hash=map_hash,
                map_nrm_hash=map_nrm_hash,
            )
        diag = OdometryDiag(fitness=fitness, overlap=overlap, promoted=promote,
                            num_corr=num_corr, nn_overflow=nn_overflow)
        return new_state, diag


def run_odometry(camera: PinholeCamera, depths, cfg: OdometryConfig = OdometryConfig()):
    """Host loop over a depth stream (arrays or tensors; the first frame's
    device is the run's); returns (poses list, diags list)."""
    depth0 = torch.as_tensor(depths[0])
    state = init_state(camera, depth0, cfg)
    poses = [torch.eye(4, device=depth0.device)]
    diags = []
    for depth in depths[1:]:
        state, diag = odometry_step(state, torch.as_tensor(depth, device=depth0.device), camera, cfg)
        poses.append(state.pose)
        diags.append(diag)
    return poses, diags
