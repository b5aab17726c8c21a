"""Plain reference of map-mode point-to-plane odometry, one step at a time.

The same step as ``odometry.py``'s keyframe mode (its ``features``: the
frame's source and keyframe clouds, the keyframe's normals), tracked
against a fused local map held in the current keyframe's frame instead of
the keyframe cloud: ``icp_iterations`` damped, Huber-weighted
Gauss-Newton updates from the warm start ``inverse(kf_pose) @ pose``,
each against the brute nearest map point, gated at ``map_nn_radius``;
the final statistics (overlap, the gated correspondences) from one more
brute pass at the solved pose; the promotion test on the step's twist
and overlap. On a promotion the map re-anchors into the new keyframe's
frame (``inverse(T)``) and absorbs the keyframe cloud: the two clouds
are concatenated, averaged by voxel of side ``map_voxel`` on a grid one
voxel below the cloud's lower corner (centroids and mean normals, the
map's points at weight ``map_decay`` and the keyframe's at 1), the mean
normals renormalised and voxels whose mean normal is shorter than 0.2
dropped (opposed normals cancelled), and the rest decimated to
``map_budget`` in voxel order: valid voxel r of N is kept where
``floor((r + 1) * ratio) > floor(r * ratio)``, ratio = min(N, budget) /
N. A step starts from a state the caller gives it (the pose, the
keyframe's pose, the map, the frame index).

The reference holds no hash. The program's voxel hash finds the exact
nearest point within its cell size (the radius) wherever a query tile's
range did not overflow, so brute nearest within the radius is the same
answer. Departures from the program's order of operations, none of them
a change of the mathematics:

- nearest neighbours are brute over the whole map (``nearest_exact``),
  in the hash's form ``(dx*dx + dy*dy) + dz*dz`` (the first of equal
  minima in map order; the hash's, in its cell order);
- the source keeps its pixel order; the program sorts it into the hash's
  cell order under the warm start (the GN sums are the same sums, added
  in another order);
- posed points and normal equations are matrix products (``Precision``),
  the program's posed points explicit sums; the 6x6 system is solved in
  float64, the program's by ``solve_ex`` in float32;
- the pose goes back onto SO(3) by ``odometry._orthonormalize``;
- voxel sums are in float64 over the valid rows alone, the program's in
  float32 over the cell-sorted rows; the decimation rule is computed in
  float32, as the program computes it, since its floors decide which
  voxels stay.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.common import (SENTINEL, Precision, full_float32, gn_step, huber_weight,
                                        inverse, se3_log, transform)
from perfbench.reference.odometry import Features, _orthonormalize, features

GRID = 1024  # voxel grid extent an axis; cells outside clamp to its faces
NORMAL_FLOOR = 0.2


class Map(NamedTuple):
    points: torch.Tensor    # (map_budget, 3), masked rows at the sentinel
    normals: torch.Tensor   # (map_budget, 3)
    mask: torch.Tensor      # (map_budget,)
    voxels: torch.Tensor    # (K, 3) centroids of every voxel that passed the normal test, before decimation
    inputs: torch.Tensor    # (I, 3) the valid points fused, in the new keyframe's frame
    from_map: torch.Tensor  # (I,) which of them are the re-anchored map's (the rest the keyframe's)
    origin: torch.Tensor    # (3,) the voxel grid's lower corner


class MapStep(NamedTuple):
    pose: np.ndarray        # (4, 4) world <- camera after the step
    promoted: bool
    margin: float           # relative distance of the promotion test from its nearest threshold
    features: Features
    map: Map                # after the step: fused on a promotion, else the one given
    src_t: torch.Tensor     # (point_budget, 3) source under the solved pose (keyframe frame)
    src_d2: torch.Tensor    # (point_budget,) squared distance to the nearest map point there
    gate: torch.Tensor      # (point_budget,) valid and within the radius


def nearest_exact(query: torch.Tensor, ref: torch.Tensor, tile: int = 2048):
    """Brute nearest neighbour of each query (N, 3) among the rows of ref
    (M, 3), whose masked rows sit at the sentinel, by ``(dx*dx + dy*dy) +
    dz*dz``, each operation rounded alone: (index (N,), squared distance),
    the first of equal minima. ``tile`` map rows at a time."""
    best = torch.full(query.shape[:1], float("inf"), dtype=query.dtype, device=query.device)
    arg = torch.zeros(query.shape[:1], dtype=torch.int64, device=query.device)
    for s in range(0, ref.shape[0], tile):
        r = ref[s:s + tile]
        dx, dy, dz = (query[:, a:a + 1] - r[:, a] for a in range(3))
        m, i = torch.min((dx * dx + dy * dy) + dz * dz, dim=1)
        take = m < best
        best, arg = torch.where(take, m, best), torch.where(take, i + s, arg)
    return arg, best


def _keep(valid: torch.Tensor, capacity: int) -> torch.Tensor:
    """The decimation's keep mask over rows in order (float32 floors)."""
    cnt = int(valid.sum())
    if cnt <= capacity:
        return valid
    ratio = torch.tensor(np.float32(capacity) / np.float32(cnt), dtype=torch.float32, device=valid.device)
    r = (torch.cumsum(valid.to(torch.int64), 0) - 1).to(torch.float32)
    return valid & (torch.floor((r + 1.0) * ratio) > torch.floor(r * ratio))


def fuse(map_pts, map_nrm, map_mask, kf, kf_nrm, kf_mask, cfg: dict) -> Map:
    """The map (given in the new keyframe's frame) with the keyframe cloud
    voxel-fused in, decimated to ``map_budget`` rows."""
    dev, budget = map_pts.device, cfg["map_budget"]
    pts = torch.cat([map_pts, kf])
    nrm = torch.cat([map_nrm, kf_nrm])
    valid = torch.cat([map_mask, kf_mask])
    w = torch.cat([torch.full((map_pts.shape[0],), float(cfg["map_decay"]), dtype=torch.float64, device=dev),
                   torch.ones(kf.shape[0], dtype=torch.float64, device=dev)])
    pts, nrm, w = pts[valid], nrm[valid], w[valid]
    vs = torch.tensor(np.float32(cfg["map_voxel"]), device=dev)
    lo = pts.amin(0) if len(pts) else torch.zeros(3, device=dev)
    origin = (torch.floor(lo / vs) - 1.0) * vs
    cell = torch.clamp(torch.floor((pts - origin) / vs).to(torch.int64), 0, GRID - 1)
    ids = (cell[:, 0] * GRID + cell[:, 1]) * GRID + cell[:, 2]
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    k = uniq.shape[0]
    wsum = torch.zeros(k, dtype=torch.float64, device=dev).index_add_(0, inv, w)
    psum = torch.zeros((k, 3), dtype=torch.float64, device=dev).index_add_(0, inv, pts.double() * w[:, None])
    nsum = torch.zeros((k, 3), dtype=torch.float64, device=dev).index_add_(0, inv, nrm.double() * w[:, None])
    live = wsum > 0
    denom = torch.clamp(wsum, min=1e-300)[:, None]
    centroid, mean_n = (psum / denom).float(), (nsum / denom).float()
    norm = torch.linalg.vector_norm(mean_n, dim=-1)
    mean_n = mean_n / torch.clamp(norm, min=1e-9)[:, None]
    good = live & (norm > NORMAL_FLOOR)
    keep = _keep(good, budget)
    n = int(keep.sum())
    out_p = torch.full((budget, 3), SENTINEL, dtype=torch.float32, device=dev)
    out_n = torch.zeros((budget, 3), dtype=torch.float32, device=dev)
    out_m = torch.zeros(budget, dtype=torch.bool, device=dev)
    out_p[:n], out_n[:n], out_m[:n] = centroid[keep], mean_n[keep], True
    return Map(out_p, out_n, out_m, centroid[good], pts, torch.arange(valid.shape[0], device=dev)[valid] <
               map_pts.shape[0], origin)


def near_face(points: torch.Tensor, origin: torch.Tensor, voxel: float, margin) -> torch.Tensor:
    """Which rows of ``points`` lie within ``margin`` (a scalar or one a
    row, metres) of a face of their voxel on the grid through ``origin``:
    a point that far off another computation's could sit in the next voxel."""
    f = (points.double() - origin.double()) / voxel
    return (torch.minimum(f - torch.floor(f), torch.ceil(f) - f).amin(-1) * voxel) <= margin


def init(depth, camera, cfg) -> tuple:
    """The first keyframe (phase 0) and the map fused from it into an empty one:
    (Features, Map)."""
    with full_float32():
        feat = features(depth, camera, cfg, 0)
        b, dev = cfg["map_budget"], depth.device
        empty = (torch.full((b, 3), SENTINEL, device=dev), torch.zeros((b, 3), device=dev),
                 torch.zeros(b, dtype=torch.bool, device=dev))
        return feat, fuse(*empty, feat.kf, feat.kf_normals, feat.kf_mask, cfg)


def step(pose, kf_pose, map_points, map_normals, map_mask, frame_index: int, depth, camera, cfg,
         prec: Precision = Precision()) -> MapStep:
    """One map-mode step from the given state; tensors on one device."""
    with full_float32():
        return _step(pose, kf_pose, map_points, map_normals, map_mask, frame_index, depth, camera, cfg, prec)


def _step(pose, kf_pose, map_points, map_normals, map_mask, frame_index, depth, camera, cfg, prec):
    feat = features(depth, camera, cfg, frame_index * 97)
    target = torch.where(map_mask[:, None], map_points, torch.full_like(map_points, SENTINEL))
    r2 = cfg["map_nn_radius"] ** 2
    T = inverse(kf_pose) @ pose
    for _ in range(cfg["icp_iterations"]):
        st = transform(T, feat.src, prec)
        idx, d2 = nearest_exact(st, target)
        gate = feat.src_mask & (d2 <= r2)
        r = (map_normals[idx] * (st - target[idx])).sum(-1)
        w = gate.to(torch.float32) * huber_weight(r, cfg["huber_delta"])
        T, _ = gn_step(T, st, target[idx], map_normals[idx], w, cfg["damping"], prec)
    st = transform(T, feat.src, prec)
    _, d2 = nearest_exact(st, target)
    gate = feat.src_mask & (d2 <= r2)
    overlap = float(gate.sum()) / max(int(feat.src_mask.sum()), 1)
    new_pose = _orthonormalize(kf_pose @ T)
    delta = se3_log(T)
    tests = [(float(torch.linalg.vector_norm(delta[:3])), cfg["kf_translation"], 1.0),
             (float(torch.linalg.vector_norm(delta[3:])), cfg["kf_rotation"], 1.0),
             (overlap, cfg["kf_min_overlap"], -1.0)]
    promoted = any(s * (v - t) > 0 for v, t, s in tests)
    margin = min(abs(v - t) / t for v, t, _ in tests)
    fused = Map(map_points, map_normals, map_mask, map_points[map_mask], map_points[:0], map_mask[:0],
                torch.zeros(3, device=map_points.device))
    if promoted:
        inv = inverse(T)
        fused = fuse(transform(inv, map_points, prec), prec.mm(map_normals, inv[:3, :3].T), map_mask,
                     feat.kf, feat.kf_normals, feat.kf_mask, cfg)
    return MapStep(new_pose.cpu().numpy(), promoted, margin, feat, fused, st, d2, gate)
