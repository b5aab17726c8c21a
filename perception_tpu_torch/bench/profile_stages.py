"""Per-stage roofline of the cuboid pipeline and of SLAM odometry on the card.

Counterpart of ``benchmarks/profile_stages.py``: the JAX script's twelve
stages at its sizes (six cuboid stages on ``render_depth_tabletop(seed=0)``
at 640x480 with ``CuboidConfig()``, six odometry stages on the SLAM
bench's room with the script's ``OdometryConfig``), each timed in steady
state (``utils/roofline.measure_stage``: a warm-up call, then ``REPS``
calls between CUDA events) and put against the card's f32 and HBM peaks.

The JAX script reads each stage's operations and bytes from XLA's cost
model. torch has none, and ``FlopCounterMode`` sees neither the
hand-written kernels (ctypes launches) nor any elementwise pass, so here
every stage is counted from its shapes and data:

- operations: every multiply, add, divide, compare, floor or select on a
  scalar is one (the kernels forbid FMA contraction); a sort of ``n`` keys
  ``n * ceil(log2 n)`` compares; per-element costs are the constants below;
- bytes: each input byte the stage needs read once, each output byte
  written once (an output that is an input tensor passed through is not
  written);
- work that depends on the data is counted as these inputs need it: the
  valid points after each compaction, RANSAC's inliers, the ICP lanes'
  iterations until they froze, the cluster's label rounds until the
  labels settle (the JAX package's loop), the pairs each voxel-hash tile
  scans, whether the odometry step promotes a keyframe;
- the kernels' terms are ``PERF.md`` §6's bound's: K1 ``PAIR_OPS`` per
  (row, hypothesis) of the rows handed to it (B * N * K), K3+K4
  ``PAIR_OPS`` per counted (query, table row) pair.

Each stage's formula is its cost function's docstring; the counted terms
go into the ``--json`` output beside the stage's K1, K2 and K3+K4 launches
by shape (the wrappers' ``launches_by_shape`` over the stage's calls).

Run: ``python -m perception_tpu_torch.bench.profile_stages [--json out.json] [--cpu]``
(on the CPU the time is the host clock's and there are no shares).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess

import numpy as np
import torch

from perception_tpu_torch.bench.timing import device_of, sync
from perception_tpu_torch.ops.kernels import wrappers

REPS = 50  # benchmarks/profile_stages.py's measure_stage default

# Per-element operation counts (see the module docstring).
PAIR_OPS = 9          # a point-plane test (3 multiplies, 3 adds, the compare, the mask, the count) or a
#                       squared distance (3 subtracts, 3 multiplies, 2 adds, the compare): K1's and K3+K4's
BACKPROJECT_OPS = 12  # a pixel: x and y (subtract, divide, multiply each), the finite test, two depth compares,
#                       two ands, the select
PASSTHROUGH_OPS = 4   # a point on one axis: two compares, two ands
COMPACT_OPS = 2       # a row into a compaction: the prefix sum's add, the scatter's select
CELL_OPS = 19         # a point's voxel id: 3 subtracts, 3 divides, 3 floors, 6 clamps, 2 multiplies, 2 adds
MEAN_OPS = 4          # a point into its voxel's coordinate sums (3) and count (1)
PLANE_OPS = 32        # a triplet's plane: two edges (6), cross product (9), norm (6), normalisation (3),
#                       offset (5), degeneracy test (3)
DRAW_OPS = 3          # a drawn row beside its binary search: scale, add, clamp
COV_OPS = 18          # an inlier into the refit: centroid (3), centred point (3), covariance (12)
EIGH_OPS = 200        # a 3x3 symmetric eigen-decomposition
NEIGHBOUR_OPS = 27    # a voxel's 27 neighbour cells, each a binary search plus its equality test
LABEL_OPS = 33        # a voxel's label round: min over 27 neighbours, 5 pointer hops, the select
RANK_OPS = 10         # a point's component: root gather, size gate, rank and stats
BLOB_OPS = CELL_OPS + MEAN_OPS + 9  # a point in the blob filter: coarse cell, cell sums, distance test
GN_OPS = 100          # a source point's Gauss-Newton terms: transform (18), residual (8), Huber weight (3),
#                       Jacobian (9), weighting (6), the 21 + 6 products and sums of J^T J and J^T r (54)
SOLVE_OPS = 400       # a damped 6x6 solve and the twist's exponential
FINAL_OPS = 4         # a source point's final statistics beside its distance: gate, weight, two sums
NORMAL_OPS = 62       # a pixel's normal: central differences (12), cross product (9), norm (6), division (3),
#                       orientation (12), validity: two tangent norms and compares (14), six ands
SUBSAMPLE_OPS = 2     # a subsampled row: stride multiply, offset add
FUSE_OPS = CELL_OPS + MEAN_OPS + 3 + 9  # a map row into fusion: cell, point sums, normal sums, renormalisation


def _sort_ops(n: int) -> int:
    return n * math.ceil(math.log2(max(n, 2)))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(x):
    """Every tensor in ``x`` (a tensor, a NamedTuple, tuple, list or dict)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def moved(inputs, outputs) -> int:
    """Bytes a stage moves: each distinct input tensor read once, each
    output tensor written once unless it is an input passed through."""
    seen, total = set(), 0
    for t in _tensors(inputs):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += _nbytes(t)
    for t in _tensors(outputs):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += _nbytes(t)
    return total


def _count(mask) -> int:
    return int(mask.sum())


# --- cuboid stages ----------------------------------------------------------


def backproject_compact(depth, camera, config):
    """``cuboid/backproject+compact``: decimate, backproject, pass z and x,
    compact to ``pre_capacity``."""
    from perception_tpu_torch.models.cuboid import decimate
    from perception_tpu_torch.ops import points as P

    depth, cam = decimate(depth, camera, config.depth_stride)
    pts, m = cam.backproject_depth(depth)
    m = P.passthrough(pts, m, 2, *config.z_limits)
    m = P.passthrough(pts, m, 0, *config.x_limits)
    return P.compact(pts, m, config.pre_capacity)


def backproject_compact_cost(depth, config, out):
    """P decimated pixels, capacity C:
    ops = P * (BACKPROJECT_OPS + 2 * PASSTHROUGH_OPS + COMPACT_OPS);
    bytes = 4 P (the decimated depth) + the (C, 3) points and (C,) mask."""
    s, o = config.depth_stride, config.depth_stride // 2
    h, w = depth.shape[-2:]
    pixels = len(range(o, h, s)) * len(range(o, w, s)) if s > 1 else h * w
    ops = pixels * (BACKPROJECT_OPS + 2 * PASSTHROUGH_OPS + COMPACT_OPS)
    return ops, 4 * pixels + moved((), out), {"pixels": pixels, "capacity": config.pre_capacity,
                                             "valid": _count(out[1])}


def voxel_compact(cpts, cm, config):
    """``cuboid/voxel+compact``: voxel-grid downsample, compact to
    ``work_capacity``."""
    from perception_tpu_torch.ops import points as P

    d0, m0 = P.voxel_downsample(cpts, cm, config.voxel_size)
    return P.compact(d0, m0, config.work_capacity)


def voxel_compact_cost(cpts, cm, config, out):
    """n valid of C input rows, V occupied voxels:
    ops = n * (CELL_OPS + MEAN_OPS) + sort(n) + 3 V + C * COMPACT_OPS;
    bytes = inputs + outputs."""
    from perception_tpu_torch.ops import points as P

    n, c = _count(cm), cm.shape[-1]
    v = _count(P.voxel_downsample(cpts, cm, config.voxel_size)[1])
    ops = n * (CELL_OPS + MEAN_OPS) + _sort_ops(n) + 3 * v + c * COMPACT_OPS
    return ops, moved((cpts, cm), out), {"valid_in": n, "voxels": v, "rows_in": c, "kept": _count(out[1])}


def ransac_stage(dpts, dm, config, generator=None, indices=None):
    """``cuboid/ransac-plane``: ``ransac_plane`` at the config's threshold
    and hypothesis count (K1 at (1, rows, hypotheses))."""
    from perception_tpu_torch.ops.ransac import ransac_plane

    return ransac_plane(dpts, dm, generator, threshold=config.ransac_threshold,
                        num_hypotheses=config.ransac_hypotheses, indices=indices)


def ransac_cost(dpts, dm, config, fit):
    """N rows, K hypotheses, I final inliers:
    ops = K * (PLANE_OPS + 3 * (DRAW_OPS + ceil(log2 N))) + PAIR_OPS * N * K (K1)
          + 2 * PAIR_OPS * N (the refit's and the final inlier passes) + COV_OPS * I + EIGH_OPS;
    bytes = points and mask read, coefficients, inliers, count and flag written."""
    n, k = dpts.shape[-2], config.ransac_hypotheses
    inl = int(fit.num_inliers)
    k1 = PAIR_OPS * n * k
    ops = k * (PLANE_OPS + 3 * (DRAW_OPS + math.ceil(math.log2(max(n, 2))))) + k1 + 2 * PAIR_OPS * n \
        + COV_OPS * inl + EIGH_OPS
    return ops, moved((dpts, dm), fit), {"rows": n, "valid": _count(dm), "hypotheses": k, "inliers": inl,
                                         "k1_ops": k1}


def compact_cluster(dpts, dm, inliers, config):
    """``cuboid/compact+cluster``: the off-plane points compacted to
    ``box_capacity``, Euclidean clustering, the largest cluster kept."""
    from perception_tpu_torch.ops import points as P
    from perception_tpu_torch.ops.cluster import euclidean_cluster

    box_pts, box_m = P.compact(dpts, dm & ~inliers, config.box_capacity)
    cl = euclidean_cluster(box_pts, box_m, tolerance=config.cluster_tolerance, min_size=1,
                           max_size=config.box_capacity, max_clusters=8)
    box_m = box_m & (cl.labels == 0)
    return P.apply_mask(box_pts, box_m), box_m


def _cluster_terms(dpts, dm, inliers, config):
    """(box points n, occupied cells V, label rounds) of ``compact_cluster``'s
    clustering: the rounds are those after which the labels no longer
    change, plus the round that finds no change (the JAX package's loop)."""
    from perception_tpu_torch.ops import points as P
    from perception_tpu_torch.ops.cluster import euclidean_cluster

    box_pts, box_m = P.compact(dpts, dm & ~inliers, config.box_capacity)
    cell = torch.floor((box_pts[box_m] + 5.0) / config.cluster_tolerance).to(torch.int64)
    cells = int(torch.unique(cell, dim=0).shape[0]) if cell.numel() else 0

    def labels(rounds):
        return euclidean_cluster(box_pts, box_m, tolerance=config.cluster_tolerance, min_size=1,
                                 max_size=config.box_capacity, max_clusters=8, max_iters=rounds).labels

    # Rounds only lower labels, so once at the fixed point they stay there:
    # bisect for the first round count that reaches it.
    settled, lo, hi = labels(64), 1, 64
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if torch.equal(labels(mid), settled) else (mid + 1, hi)
    return _count(box_m), cells, min(lo + 1, 64)


def compact_cluster_cost(dpts, dm, inliers, config, out):
    """N work rows, n box points in V occupied cells, R label rounds:
    ops = N * (1 + COMPACT_OPS) + n * (CELL_OPS + RANK_OPS) + sort(n)
          + V * NEIGHBOUR_OPS * (ceil(log2 V) + 1) + R * V * LABEL_OPS;
    bytes = points, mask and inliers read, the box points and mask written."""
    n_rows = dpts.shape[-2]
    nb, cells, rounds = _cluster_terms(dpts, dm, inliers, config)
    ops = n_rows * (1 + COMPACT_OPS) + nb * (CELL_OPS + RANK_OPS) + _sort_ops(nb) \
        + cells * NEIGHBOUR_OPS * (math.ceil(math.log2(max(cells, 2))) + 1) + rounds * cells * LABEL_OPS
    return ops, moved((dpts, dm, inliers), out), {"rows": n_rows, "box_points": nb, "cells": cells,
                                                  "label_rounds": rounds, "kept": _count(out[1])}


def icp_stage(box_pts, box_m, template, tmask, tnormals, config):
    """``cuboid/icp(RxI)``: ``estimate_cuboid_pose``, R yaw restarts of
    point-to-plane ICP against the template."""
    from perception_tpu_torch.models.cuboid import estimate_cuboid_pose

    return estimate_cuboid_pose(box_pts, box_m, template, tmask, config, template_normals=tnormals)


def _icp_iterations(box_pts, box_m, template, tmask, tnormals, config):
    """Each restart lane's iterations until it froze: the ICP call of
    ``estimate_cuboid_pose``, made once more for its ``iterations``."""
    from perception_tpu_torch.models.cuboid import _yaw_restart_inits
    from perception_tpu_torch.ops import points as P
    from perception_tpu_torch.ops.icp import icp_point_to_plane

    k = config.icp_restarts
    inits = _yaw_restart_inits(P.centroid(box_pts, box_m), P.centroid(template, tmask), k, box_pts.dtype)
    res = icp_point_to_plane(box_pts.expand((k,) + box_pts.shape), box_m.expand((k,) + box_m.shape),
                             template, tnormals, tmask, inits, max_iterations=config.icp_max_iterations,
                             transformation_epsilon=1e-12)
    return [int(i) for i in res.iterations.cpu()]


def icp_cost(box_pts, box_m, template, tmask, tnormals, config, out):
    """n source points, m template points, lanes' iterations i_l (R lanes):
    ops = sum_l i_l * (PAIR_OPS * n * m + GN_OPS * n + SOLVE_OPS) + R * (PAIR_OPS * n * m + FINAL_OPS * n);
    bytes = the box cloud and the template read, pose, fitness and flag written."""
    n, m = _count(box_m), _count(tmask)
    its = _icp_iterations(box_pts, box_m, template, tmask, tnormals, config)
    ops = sum(its) * (PAIR_OPS * n * m + GN_OPS * n + SOLVE_OPS) + len(its) * (PAIR_OPS * n * m + FINAL_OPS * n)
    return ops, moved((box_pts, box_m, template, tmask, tnormals), out), {
        "source": n, "template": m, "lane_iterations": its}


def full_pipeline(depth, camera, template, tmask, tnormals, config, generator=None, indices=None):
    """``cuboid/FULL-pipeline``: ``cuboid_pipeline_from_depth``."""
    from perception_tpu_torch.models.cuboid import cuboid_pipeline_from_depth

    return cuboid_pipeline_from_depth(depth, camera, template, tmask, generator, config,
                                      template_normals=tnormals, indices=indices)


def full_cost(parts, n_rows, box_candidates, depth_bytes, template_bytes, out):
    """The pipeline on this frame: the staged counts of backproject+compact,
    voxel+compact, RANSAC and ICP, plus the box compaction and the blob
    filter (the pipeline's default ``cluster_filter``) in place of the
    clusterer: ops = sum of those + N * (1 + COMPACT_OPS) + b * BLOB_OPS +
    sort(b) for b off-plane points; bytes = the decimated depth and the
    template read, the result written (intermediates stay on the card)."""
    ops = sum(parts) + n_rows * (1 + COMPACT_OPS) + box_candidates * BLOB_OPS + _sort_ops(box_candidates)
    return ops, depth_bytes + template_bytes + moved((), out), {"staged_ops": list(parts),
                                                                "box_candidates": box_candidates}


# --- odometry stages ---------------------------------------------------------

ODOM = dict(point_budget=2048, keyframe_budget=4096, icp_iterations=8, min_depth=0.1, max_depth=6.0,
            normal_max_edge=0.1)  # the JAX script's OdometryConfig
NN_QUERIES, NN_SMALL, NN_LARGE = 2048, 4096, 32768
HASH_CELL = 0.06


def frame_features_cost(depth, cfg, out):
    """P = H * W pixels, budgets Ns and Nk:
    ops = P * (BACKPROJECT_OPS + NORMAL_OPS) + (Ns + Nk) * SUBSAMPLE_OPS;
    bytes = the depth read, the subsampled points, normals and masks written."""
    pixels = depth.shape[-2] * depth.shape[-1]
    ops = pixels * (BACKPROJECT_OPS + NORMAL_OPS) + (cfg.point_budget + cfg.keyframe_budget) * SUBSAMPLE_OPS
    return ops, moved(depth, out), {"pixels": pixels, "source_valid": _count(out[1]),
                                    "keyframe_valid": _count(out[4])}


def _state_tensors(state):
    """The state's tensors without the hash placeholder of modes that never
    query it."""
    return [t for name, t in state._asdict().items() if name not in ("map_hash", "map_nrm_hash")]


def step_cost(state, depth, camera, cfg, out):
    """One ``odometry_step``, ns valid source points, I iterations:
    keyframe mode (nk valid keyframe points):
      ops = features + I * (PAIR_OPS * ns * nk + GN_OPS * ns + SOLVE_OPS) + PAIR_OPS * ns * nk + FINAL_OPS * ns;
    map mode, shortlist engine (m valid map points, k candidates, p brute
    polish iterations, I - p shortlisted ones, one build):
      ops = features + PAIR_OPS * ns * m + ns * m (the build's distances and
            top-k compares) + (I - p) * (PAIR_OPS * ns * k + GN_OPS * ns + SOLVE_OPS)
            + p * (PAIR_OPS * ns * (m + k) + GN_OPS * ns + SOLVE_OPS)
            + [promoted] * ((m + nk) * FUSE_OPS + sort(m + nk));
    bytes = the depth and the state read, the new state and diagnostics
    written (a state tensor passed through unchanged is not written)."""
    from perception_tpu_torch.models.slam.odometry import _frame_features, _map_engine

    feats = _frame_features(camera, depth, cfg)
    f_ops, _, f_terms = frame_features_cost(depth, cfg, feats)
    ns, it = f_terms["source_valid"], cfg.icp_iterations
    new_state, diag = out
    promoted = bool(diag.promoted)
    terms = {"features_ops": f_ops, "source_valid": ns, "iterations": it, "promoted": promoted}
    if cfg.map_budget > 0:
        if _map_engine(cfg) != "shortlist":
            raise ValueError("step_cost counts the shortlist engine only")
        m, k, nk = _count(state.map_mask), cfg.map_nn_shortlist, f_terms["keyframe_valid"]
        p = max(cfg.map_nn_polish, 1)
        ops = f_ops + PAIR_OPS * ns * m + ns * m + max(it - p, 0) * (PAIR_OPS * ns * k + GN_OPS * ns + SOLVE_OPS) \
            + p * (PAIR_OPS * ns * (m + k) + GN_OPS * ns + SOLVE_OPS)
        if promoted:
            ops += (m + nk) * FUSE_OPS + _sort_ops(m + nk)
        terms.update(map_valid=m, shortlist=k, polish=p, keyframe_valid=nk)
    else:
        nk = _count(state.kf_mask)
        ops = f_ops + it * (PAIR_OPS * ns * nk + GN_OPS * ns + SOLVE_OPS) + PAIR_OPS * ns * nk + FINAL_OPS * ns
        terms.update(keyframe_valid=nk)
    return ops, moved((depth, *_state_tensors(state)), (*_state_tensors(new_state), diag)), terms


def brute_nn_cost(q, ref, mask, out):
    """Q queries, m valid reference points: ops = PAIR_OPS * Q * m;
    bytes = queries, reference and mask read, indices and distances written."""
    m = _count(mask)
    return PAIR_OPS * q.shape[0] * m, moved((q, ref, mask), out), {"queries": q.shape[0], "reference": m}


def hash_pairs(vh, q) -> int:
    """The (query, table row) pairs K3+K4 scans for ``voxelhash.query(vh, q)``:
    the queries in cell order, each tile's window rows (its chunk count times
    the chunk, within the range cap and the table) times the tile
    (``chip_smoke.time_k3``'s count)."""
    from perception_tpu_torch.ops import voxelhash

    _, order = torch.sort(voxelhash._cell_ids(q, vh.origin, vh.cell_size, vh.dims), stable=True)
    (table, _, start, nchunk, tile, R, rblk), _ = voxelhash.kernel_args(vh, q[order])
    rows = torch.minimum(torch.clamp(nchunk.long() * rblk, max=R), table.shape[0] - start.long())
    return int(rows.sum()) * tile


def hash_nn_cost(vh, q, out):
    """Q queries, S counted pairs (``hash_pairs``):
    ops = PAIR_OPS * S (K3+K4) + Q * CELL_OPS + sort(Q) (the queries into cell order);
    bytes = the table and the cell ids the query reads, the queries, indices
    and distances."""
    pairs = hash_pairs(vh, q)
    nq = q.shape[0]
    ops = PAIR_OPS * pairs + nq * CELL_OPS + _sort_ops(nq)
    return ops, moved((vh.table, vh.cell_ids, q), out), {"queries": nq, "pairs": pairs,
                                                         "table_rows": vh.table.shape[0], "k3_ops": PAIR_OPS * pairs}


# --- the run ------------------------------------------------------------------


def _launch_snapshot():
    return {name: dict(w.launches_by_shape) for name, w in wrappers().items()}


def _launch_delta(before):
    out = {}
    for name, now in _launch_snapshot().items():
        diff = {shape: n - before[name].get(shape, 0) for shape, n in now.items() if n != before[name].get(shape, 0)}
        if diff:
            out[name] = diff
    return out


def _stage(results, name, fn, args, cost_fn, device, reps):
    """One stage: its warm-up call (the JAX script's ``_ = fn(...)``),
    ``measure_stage`` with the counted cost, the launches of both."""
    from perception_tpu_torch.utils.roofline import measure_stage

    before = _launch_snapshot()
    out = fn(*args)
    sync(out)
    ops, nbytes, terms = cost_fn(out)
    st = measure_stage(name, fn, *args, reps=reps, cost=(float(ops), float(nbytes)), device=device)
    st.terms = terms
    st.launches = _launch_delta(before)
    results.append(st)
    return out


def cuboid_stages(results, device, reps=REPS):
    from perception_tpu_torch.bench.scene import benchmark_template, render_depth_tabletop
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.cuboid import CuboidConfig, template_features

    camera = PinholeCamera.d435_depth()
    config = CuboidConfig()
    template_np = benchmark_template()
    template, tnormals, tmask = template_features(template_np, np.ones(len(template_np), bool), config,
                                                  device=device)
    depth = torch.from_numpy(render_depth_tabletop(camera, seed=0)).to(device)

    def key():  # the script's one key: each call draws the same triplets
        return torch.Generator(device=device).manual_seed(0)

    cpts, cm = _stage(results, "cuboid/backproject+compact", lambda d: backproject_compact(d, camera, config),
                      (depth,), lambda o: backproject_compact_cost(depth, config, o), device, reps)
    dpts, dm = _stage(results, "cuboid/voxel+compact", lambda p, m: voxel_compact(p, m, config), (cpts, cm),
                      lambda o: voxel_compact_cost(cpts, cm, config, o), device, reps)
    fit = _stage(results, "cuboid/ransac-plane", lambda p, m: ransac_stage(p, m, config, key()), (dpts, dm),
                 lambda o: ransac_cost(dpts, dm, config, o), device, reps)
    box_pts, box_m = _stage(results, "cuboid/compact+cluster", lambda p, m, i: compact_cluster(p, m, i, config),
                            (dpts, dm, fit.inliers), lambda o: compact_cluster_cost(dpts, dm, fit.inliers, config, o),
                            device, reps)
    _stage(results, f"cuboid/icp({config.icp_restarts}x{config.icp_max_iterations})",
           lambda p, m: icp_stage(p, m, template, tmask, tnormals, config), (box_pts, box_m),
           lambda o: icp_cost(box_pts, box_m, template, tmask, tnormals, config, o), device, reps)
    parts = [st.flops for st in results[-5:] if st.name != "cuboid/compact+cluster"]
    pixels = results[-5].terms["pixels"]
    _stage(results, "cuboid/FULL-pipeline", lambda d: full_pipeline(d, camera, template, tmask, tnormals, config,
                                                                     key()), (depth,),
           lambda o: full_cost(parts, dpts.shape[-2], _count(dm & ~fit.inliers), 4 * pixels,
                               moved((), (template, tnormals, tmask)), o), device, reps)


def odometry_stages(results, device, reps=REPS):
    """SLAM odometry: frame features, brute-NN GN (keyframe mode), and
    voxel-hash NN (map mode at 32k): the stages the GN-ICP kernel verdict
    rests on."""
    from perception_tpu_torch.bench.slam_bench import bench_camera
    from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
    from perception_tpu_torch.models.slam.odometry import OdometryConfig, _frame_features, init_state, odometry_step
    from perception_tpu_torch.ops import nn as _nn
    from perception_tpu_torch.ops import voxelhash
    from perception_tpu_torch.utils import jax_random

    camera = bench_camera(640, 480)
    gt = sweep_trajectory(n=4)
    frames = [render_textured_room(camera, T, seed=i)[1] for i, T in enumerate(gt)]
    cfg = OdometryConfig(**ODOM)
    d0, d1 = (torch.from_numpy(f).to(device) for f in frames[:2])

    _stage(results, "odom/frame-features(640x480)", lambda d: _frame_features(camera, d, cfg), (d1,),
           lambda o: frame_features_cost(d1, cfg, o), device, reps)
    state = init_state(camera, d0, cfg)
    _stage(results, f"odom/step-keyframe({cfg.point_budget}x{cfg.keyframe_budget})",
           lambda s, d: odometry_step(s, d, camera, cfg), (state, d1),
           lambda o: step_cost(state, d1, camera, cfg, o), device, reps)

    def cloud(seed, n, scale=1.0):  # jax.random.normal(key(seed), (n, 3)) * scale, drawn in numpy
        return torch.from_numpy(jax_random.normal(jax_random.key(seed), (n, 3)) * np.float32(scale)).to(device)

    q, ref, ref32 = cloud(0, NN_QUERIES), cloud(1, NN_SMALL), cloud(2, NN_LARGE, 2.0)
    mask, m32 = (torch.ones(n, dtype=torch.bool, device=device) for n in (NN_SMALL, NN_LARGE))
    for r, m in ((ref, mask), (ref32, m32)):
        _stage(results, f"odom/brute-NN({NN_QUERIES}x{r.shape[0]})", _nn.nearest_neighbor, (q, r, m),
               lambda o, r=r, m=m: brute_nn_cost(q, r, m, o), device, reps)
    vh = voxelhash.build(ref32, m32, cell_size=HASH_CELL)
    _stage(results, f"odom/voxelhash-NN({NN_QUERIES}x{NN_LARGE})", voxelhash.query, (vh, q),
           lambda o: hash_nn_cost(vh, q, o), device, reps)

    cfg_map = dataclasses.replace(cfg, map_budget=32768)
    state_m = init_state(camera, d0, cfg_map)
    _stage(results, "odom/step-map32k", lambda s, d: odometry_step(s, d, camera, cfg_map), (state_m, d1),
           lambda o: step_cost(state_m, d1, camera, cfg_map, o), device, reps)


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def run(device="cuda", reps=REPS) -> dict:
    """All twelve stages: {"device", "peaks_f32_tflops_bf16_tflops_hbm_gbps",
    "stages": [StageRoofline as a dict]} (the JAX script's JSON; each stage
    also with its counted terms and its launches, keyed by kernel and
    shape)."""
    from perception_tpu_torch.utils.roofline import device_peaks

    device = device_of(device)
    results = []
    cuboid_stages(results, device, reps)
    odometry_stages(results, device, reps)
    return {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peaks_f32_tflops_bf16_tflops_hbm_gbps": device_peaks(device),
        "stages": [dataclasses.asdict(st) for st in results],
    }


def _jsonable(x):
    """``x`` with each tuple key (a launch shape) written as "BxNxK"."""
    if isinstance(x, dict):
        return {("x".join(map(str, k)) if isinstance(k, tuple) else k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def rows(out: dict):
    """The table ``main`` prints: the header, then one row per stage."""
    from perception_tpu_torch.utils.roofline import HEADER, StageRoofline

    fields = {f.name for f in dataclasses.fields(StageRoofline)}
    return [HEADER] + [StageRoofline(**{k: v for k, v in st.items() if k in fields}).row() for st in out["stages"]]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", dest="json_out", default=None, help="write the stages to this file")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    device = device_of("cpu" if args.cpu else "cuda")
    print(card_line(device))
    out = run(device)
    print(f"device: {out['device']} ({device.type}); peaks (f32 TFLOP/s, bf16 TFLOP/s, HBM GB/s) = "
          f"{out['peaks_f32_tflops_bf16_tflops_hbm_gbps']}")
    for line in rows(out):
        print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(_jsonable(out), f, indent=1)
        print(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
