"""Streaming multi-object ICP tracking on torch tensors.

Counterpart of ``perception_tpu/models/object_tracking.py``:

  depth -> stride decimation + backprojection -> the detection service's
  front end (passthrough, voxel, RANSAC plane removal, clustering) ->
  greedy centroid assignment of clusters to K track slots -> one batched
  point-to-plane ICP over K x (2 warm + R yaw-restart) rows -> row
  selection by fitness, overlap and centroid gates -> the per-slot latch
  state machine (latch on a pass, count misses while latched, unlatch
  after ``max_misses``).

The JAX package's ``lax.cond(steady, _solve_warm, _solve_full)`` is a
host branch here: ``track_step`` reads ``steady`` once a frame. The two
branches solve different rows, so computing both and masking would not
be the same function. The greedy assignment stays a Python loop over K.
Other host reads come from the library: the plane refit's
``torch.linalg.eigh`` in RANSAC.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.cuboid import _yaw_restart_inits, decimate
from perception_tpu_torch.models.objects import ObjectConfig, front_end
from perception_tpu_torch.ops import points as P
from perception_tpu_torch.ops.cluster import gather_clusters
from perception_tpu_torch.ops.icp import ICPResult, icp_point_to_plane
from perception_tpu_torch.ops.normals import normals_knn


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracker parameters; the defaults and their reasons are those of the
    JAX package's ``TrackingConfig``."""

    detection: ObjectConfig = ObjectConfig()
    max_tracks: int = 4
    warm_icp_iterations: int = 60
    redetect_restarts: int = 4
    fitness_gate: float = 0.0004
    corr_radius: float = 0.015
    min_overlap: float = 0.8
    center_gate: float = 0.04
    max_misses: int = 5
    match_radius: float = 0.15
    cold_size_gate: float = 0.35
    depth_stride: int = 2


class TrackSlots(NamedTuple):
    pose: torch.Tensor      # (K, 4, 4) camera <- object (published pose)
    latched: torch.Tensor   # (K,) bool — ICP_SUCCESS latch
    fitness: torch.Tensor   # (K,) last accepted fitness
    misses: torch.Tensor    # (K,) int32 consecutive gate failures
    age: torch.Tensor       # (K,) int32 frames since latch


class TrackDiag(NamedTuple):
    num_clusters: torch.Tensor   # () int32
    assigned: torch.Tensor       # (K,) int32 cluster id per slot (-1 none)
    fresh_fitness: torch.Tensor  # (K,) this frame's best solve fitness
    used_warm: torch.Tensor      # (K,) bool — the warm row won this frame


def init_tracks(cfg: TrackingConfig = TrackingConfig(), device="cuda") -> TrackSlots:
    K = cfg.max_tracks
    return TrackSlots(
        pose=torch.eye(4, device=device).expand(K, 4, 4).contiguous(),
        latched=torch.zeros(K, dtype=torch.bool, device=device),
        fitness=torch.full((K,), float("inf"), device=device),
        misses=torch.zeros(K, dtype=torch.int32, device=device),
        age=torch.zeros(K, dtype=torch.int32, device=device),
    )


def slot_template_normals(templates: torch.Tensor, template_masks: torch.Tensor) -> torch.Tensor:
    """kNN-PCA normals (k=8) of each (K, Nt, 3) template: (K, Nt, 3)."""
    return torch.stack([normals_knn(t, m, k=8)[0] for t, m in zip(templates, template_masks)])


def _front_end(points, mask, generator, det: ObjectConfig, indices=None):
    """The streaming front end: (cluster points (C, cap, 3), masks,
    centroids, sizes, alive, num_clusters, keep_ratio)."""
    opts, clusters, keep_ratio = front_end(points, mask, generator, det, indices)
    cpts, cmasks = gather_clusters(opts, clusters.labels, det.max_clusters, det.cluster_capacity)
    alive = clusters.sizes > 0
    return (cpts, cmasks, P.centroid(cpts, cmasks), clusters.sizes, alive,
            clusters.num_clusters, keep_ratio)


def _assign(slots: TrackSlots, pred, centroids, alive, t_rel, c_rel, cfg: TrackingConfig):
    """Greedy slot-major assignment: a live track takes its nearest free
    cluster within ``match_radius``; a free slot cold-detects the free
    cluster whose normalised size is nearest its template's, under
    ``cold_size_gate``. Returns (K,) int32 cluster ids (-1 none)."""
    C = centroids.shape[0]
    taken = torch.zeros(C, dtype=torch.bool, device=centroids.device)
    cols = torch.arange(C, device=centroids.device)
    inf = torch.full((), float("inf"), dtype=centroids.dtype, device=centroids.device)
    assigned = []
    for k in range(cfg.max_tracks):
        free = alive & ~taken
        d = torch.where(free, torch.linalg.vector_norm(pred[k][None] - centroids, dim=-1), inf)
        sdiff = torch.where(free, torch.abs(c_rel - t_rel[k]), inf)
        track_live = slots.latched[k] & (slots.misses[k] <= cfg.max_misses)
        j = torch.argmin(torch.where(track_live, d, sdiff), dim=0, keepdim=True)
        ok = torch.where(track_live, d.gather(0, j) <= cfg.match_radius, sdiff.gather(0, j) < cfg.cold_size_gate)[0]
        assigned.append(torch.where(ok, j[0], torch.full_like(j[0], -1)).to(torch.int32))
        taken = taken | ((cols == j) & ok)
    return torch.stack(assigned)


def track_step(
    slots: TrackSlots,
    points: torch.Tensor,
    mask: torch.Tensor,
    templates: torch.Tensor,
    template_masks: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg: TrackingConfig = TrackingConfig(),
    template_normals: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> Tuple[TrackSlots, TrackDiag]:
    """One streaming frame of an (N, 3) masked cloud against per-slot
    templates (K, Nt, 3) with masks (K, Nt); pass their normals
    (``template_normals``, e.g. ``slot_template_normals``) to skip
    recomputing them every frame. RANSAC
    triplets come from ``generator`` or are given as ``indices``."""
    det = cfg.detection
    K, R = cfg.max_tracks, cfg.redetect_restarts
    dt = points.dtype
    if template_normals is None:
        template_normals = slot_template_normals(templates, template_masks)

    cpts, cmasks, centroids, csizes, alive, n_clusters, _ = _front_end(points, mask, generator, det, indices)

    # Predicted object centroid per slot: the latched pose on the template centroid.
    t_cents = P.centroid(templates, template_masks)                                     # (K, 3)
    pred = (slots.pose[:, :3, :3] @ t_cents[..., None])[..., 0] + slots.pose[:, :3, 3]

    # Max-normalised template and cluster sizes at the working resolution.
    t_sizes = torch.stack([torch.sum(P.voxel_downsample(t, m, det.voxel_size)[1], dtype=dt)
                           for t, m in zip(templates, template_masks)])
    t_rel = t_sizes / torch.clamp(t_sizes.max(), min=1.0)
    c_rel = csizes.to(dt) / torch.clamp(torch.where(alive, csizes, torch.zeros_like(csizes)).max().to(dt), min=1.0)
    assigned = _assign(slots, pred, centroids, alive, t_rel, c_rel, cfg)

    a_idx = torch.clamp(assigned, min=0).long()
    src = cpts[a_idx]                                                                   # (K, cap, 3)
    srcm = cmasks[a_idx] & (assigned >= 0)[:, None]

    # Rows per slot (ICP solves cluster -> template, so inits are pose
    # inverses): the re-centred warm start, the plain warm start, then R
    # yaw restarts about the assigned cluster's centroid.
    warm = se3.inverse(slots.pose)
    c_assigned = centroids[a_idx]
    recenter_t = t_cents - (warm[:, :3, :3] @ c_assigned[..., None])[..., 0]
    warm_centered = se3.make_T(warm[:, :3, :3], recenter_t)
    cold = torch.stack([_yaw_restart_inits(c_assigned[k], t_cents[k], R, dt) for k in range(K)])  # (K, R, 4, 4)
    inits = torch.cat([warm_centered[:, None], warm[:, None], cold], dim=1)            # (K, R + 2, 4, 4)
    n_rows = R + 2

    # Steady state (every slot latched with no recent miss) solves only the
    # two warm rows; the rest report inf fitness. One host read a frame.
    steady = bool(torch.all(slots.latched & (slots.misses == 0)))
    rows = 2 if steady else n_rows
    res = icp_point_to_plane(
        src[:, None].expand(K, rows, *src.shape[1:]), srcm[:, None].expand(K, rows, srcm.shape[1]),
        templates[:, None], template_normals[:, None], template_masks[:, None], inits[:, :rows],
        max_iterations=cfg.warm_icp_iterations,
        transformation_epsilon=1e-12,
        max_correspondence_distance=cfg.corr_radius,
    )
    if steady:
        pad = dict(device=points.device, dtype=torch.int32)
        res = ICPResult(
            transform=torch.cat([res.transform, torch.eye(4, dtype=dt, device=points.device).expand(K, R, 4, 4)], 1),
            fitness=torch.cat([res.fitness, torch.full((K, R), float("inf"), dtype=dt, device=points.device)], 1),
            num_corr=torch.cat([res.num_corr, torch.zeros((K, R), **pad)], 1),
            iterations=torch.cat([res.iterations, torch.zeros((K, R), **pad)], 1),
            converged=torch.cat([res.converged, torch.zeros((K, R), dtype=torch.bool, device=points.device)], 1),
        )
    inf = torch.full((), float("inf"), dtype=dt, device=points.device)
    fit = torch.where((assigned >= 0)[:, None], res.fitness, inf)                       # (K, R + 2)
    # Overlap per row (gated correspondences over live cluster points), and
    # the implied template centroid per row against the assigned cluster's.
    n_src = torch.sum(srcm, dim=1).to(dt)
    ovl = res.num_corr.to(dt) / torch.clamp(n_src, min=1.0)[:, None]
    pose_rows = se3.inverse(res.transform)
    pred_c = (pose_rows[..., :3, :3] @ t_cents[:, None, :, None])[..., 0] + pose_rows[..., :3, 3]
    cdist = torch.linalg.vector_norm(pred_c - c_assigned[:, None, :], dim=-1)
    row_pass = ((fit < cfg.fitness_gate) & (ovl >= cfg.min_overlap) & (cdist <= cfg.center_gate)
                & (assigned >= 0)[:, None])
    # A latched slot whose re-centred warm row passes keeps it; otherwise the
    # best passing row, else the best row.
    warm_ok = slots.latched & row_pass[:, 0]
    any_pass = torch.any(row_pass, dim=1)
    best = torch.where(
        warm_ok, torch.zeros_like(any_pass, dtype=torch.int64),
        torch.where(any_pass, torch.argmin(torch.where(row_pass, fit, inf), dim=1), torch.argmin(fit, dim=1)),
    )
    best_fit = torch.take_along_dim(fit, best[:, None], dim=1)[:, 0]
    best_T = torch.take_along_dim(res.transform, best[:, None, None, None], dim=1)[:, 0]
    fresh_pose = se3.inverse(best_T)

    # The latch state machine.
    passed = any_pass
    new_pose = torch.where(passed[:, None, None], fresh_pose, slots.pose)
    new_misses = torch.where(passed, torch.zeros_like(slots.misses), slots.misses + slots.latched.to(torch.int32))
    new_latched = (slots.latched | passed) & ~(new_misses > cfg.max_misses)
    new_fitness = torch.where(passed, best_fit, slots.fitness)
    new_age = torch.where(new_latched, slots.age + 1, torch.zeros_like(slots.age))

    diag = TrackDiag(num_clusters=n_clusters, assigned=assigned, fresh_fitness=best_fit,
                     used_warm=(best == 0) & passed)
    return TrackSlots(pose=new_pose, latched=new_latched, fitness=new_fitness, misses=new_misses,
                      age=new_age), diag


def track_step_from_depth(
    slots: TrackSlots,
    depth: torch.Tensor,
    camera,
    templates: torch.Tensor,
    template_masks: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg: TrackingConfig = TrackingConfig(),
    template_normals: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> Tuple[TrackSlots, TrackDiag]:
    """The streaming entry point from a raw (H, W) depth image in metres."""
    depth, camera = decimate(depth, camera, cfg.depth_stride)
    pts, valid = camera.backproject_depth(depth, min_depth=0.05, max_depth=5.0)
    return track_step(slots, pts, valid, templates, template_masks, generator, cfg,
                      template_normals=template_normals, indices=indices)
