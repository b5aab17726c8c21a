"""The multi-object detection service on torch tensors.

Counterpart of ``perception_tpu/models/objects.py`` (the reference's
``detect_objects`` ROS service):

  cloud -> passthrough z/x -> voxel downsample -> working-set compaction
  -> RANSAC plane removal -> z < table_z_cut -> off-plane compaction ->
  Euclidean clustering -> one batched point-to-point ICP over every
  (cluster, yaw restart) pair against the class template -> winner =
  min |cluster size - template size|, success iff under ``size_gate``.

The RANSAC triplets come from an explicit ``torch.Generator``, or are
given as ``indices`` (rows of the compacted working set). Host reads:
the plane refit's ``torch.linalg.eigh`` and the ICP's per-iteration
``torch.linalg.svd`` wait for the card inside the library, and the ICP
reads ``done.all()`` every ``ops.icp.DONE_CHECK_EVERY`` iterations.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.cuboid import _yaw_restart_inits
from perception_tpu_torch.ops import points as P
from perception_tpu_torch.ops.cluster import euclidean_cluster, gather_clusters
from perception_tpu_torch.ops.icp import icp_batched
from perception_tpu_torch.ops.ransac import ransac_plane


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """Service parameters; the defaults and their reasons are those of the
    JAX package's ``ObjectConfig``."""

    z_limits: Tuple[float, float] = (0.0, 0.9)
    x_limits: Tuple[float, float] = (-0.25, 0.25)
    voxel_size: float = 0.004
    ransac_hypotheses: int = 1024
    ransac_threshold: float = 0.01
    table_z_cut: float = 0.75
    cluster_tolerance: float = 0.02
    exact_clustering: bool = False      # point-level radius edges (refine=True)
    cluster_min_size: int = 200
    cluster_max_size: int = 25000
    max_clusters: int = 8
    cluster_capacity: int = 4096
    offplane_capacity: int = 8192
    work_capacity: int = 32768
    icp_restarts: int = 4
    icp_max_iterations: int = 100
    size_gate: int = 250                # |cluster - template| point gate


class ObjectDetectionResult(NamedTuple):
    success: torch.Tensor        # () bool — the service's response
    pose: torch.Tensor           # (4, 4) camera <- object (winning cluster)
    fitness: torch.Tensor        # () winning ICP fitness
    cluster_id: torch.Tensor     # () int32 winning cluster slot (-1 if none)
    size_diff: torch.Tensor      # () int32 |cluster size - template size|
    num_clusters: torch.Tensor   # () int32
    cluster_sizes: torch.Tensor  # (max_clusters,) int32


def working_set(points, mask, config: ObjectConfig):
    """Passthrough z/x, voxel downsample and, past ``work_capacity``, the
    prefix compaction: (points, mask, keep_ratio) as RANSAC sees them.
    Triplet ``indices`` index these rows."""
    m = P.passthrough(points, mask, 2, *config.z_limits)
    m = P.passthrough(points, m, 0, *config.x_limits)
    dpts, dm = P.voxel_downsample(points, m, config.voxel_size)
    keep_ratio = torch.ones((), dtype=points.dtype, device=points.device)
    if dpts.shape[0] > config.work_capacity:
        cnt = torch.sum(dm, dtype=points.dtype)
        # A tensor numerator keeps this a true division.
        keep_ratio = torch.clamp(const(float(config.work_capacity), points) / torch.clamp(cnt, min=1.0), max=1.0)
        dpts, dm = P.compact_prefix(dpts, dm, config.work_capacity)
    return dpts, dm, keep_ratio


def front_end(points, mask, generator, config: ObjectConfig, indices=None):
    """Working set -> RANSAC plane removal -> z cut -> off-plane compaction
    -> clustering. Returns (off-plane points, Clusters, keep_ratio)."""
    dpts, dm, keep_ratio = working_set(points, mask, config)
    plane = ransac_plane(dpts, dm, generator, threshold=config.ransac_threshold,
                         num_hypotheses=config.ransac_hypotheses, indices=indices)
    off = P.passthrough(dpts, dm & ~plane.inliers, 2, 0.0, config.table_z_cut)
    opts, om = P.compact(dpts, off, config.offplane_capacity)
    clusters = euclidean_cluster(
        opts, om,
        tolerance=config.cluster_tolerance,
        min_size=config.cluster_min_size,
        max_size=config.cluster_max_size,
        max_clusters=config.max_clusters,
        refine=config.exact_clustering,
    )
    return opts, clusters, keep_ratio


def detect_object(
    points: torch.Tensor,
    mask: torch.Tensor,
    template: torch.Tensor,
    template_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: ObjectConfig = ObjectConfig(),
    indices: Optional[torch.Tensor] = None,
) -> ObjectDetectionResult:
    """Run the detection service on an (N, 3) masked cloud against one
    class template (Nt, 3) with its mask."""
    C, K = config.max_clusters, config.icp_restarts
    opts, clusters, keep_ratio = front_end(points, mask, generator, config, indices)
    cluster_pts, cluster_masks = gather_clusters(opts, clusters.labels, C, config.cluster_capacity)

    # Restart inits per cluster: centroid shift + yaw fan, flattened into
    # one batch of C * K alignments.
    ct = P.centroid(template, template_mask)
    inits = _yaw_restart_inits(P.centroid(cluster_pts, cluster_masks), ct, K, points.dtype)  # (C, K, 4, 4)
    res = icp_batched(
        cluster_pts.repeat_interleave(K, dim=0), cluster_masks.repeat_interleave(K, dim=0),
        template, template_mask, init_transforms=inits.reshape(C * K, 4, 4),
        max_iterations=config.icp_max_iterations,
    )
    alive = clusters.sizes > 0
    inf = torch.full((), float("inf"), dtype=points.dtype, device=points.device)
    fitness_ck = torch.where(alive[:, None], res.fitness.reshape(C, K), inf)  # dead clusters fit 0
    best_k = torch.argmin(fitness_ck, dim=1, keepdim=True)
    best_fit = torch.take_along_dim(fitness_ck, best_k, dim=1)[:, 0]
    best_T = torch.take_along_dim(res.transform.reshape(C, K, 4, 4), best_k[..., None, None], dim=1)[:, 0]

    # The template counted at the clusters' resolution and working-set ratio.
    _, tmpl_dm = P.voxel_downsample(template, template_mask, config.voxel_size)
    tmpl_size = torch.round(torch.sum(tmpl_dm, dtype=points.dtype) * keep_ratio).to(torch.int32)
    diffs = torch.abs(clusters.sizes - tmpl_size)
    diffs = torch.where(alive, diffs, torch.full_like(diffs, torch.iinfo(torch.int32).max))
    win = torch.argmin(diffs, dim=0, keepdim=True)
    win_diff = diffs.gather(0, win)[0]
    success = (win_diff < config.size_gate) & (clusters.num_clusters > 0)
    win_i32 = win[0].to(torch.int32)
    return ObjectDetectionResult(
        success=success,
        pose=se3.inverse(best_T.index_select(0, win)[0]),
        fitness=best_fit.gather(0, win)[0],
        cluster_id=torch.where(success, win_i32, torch.full_like(win_i32, -1)),
        size_diff=win_diff,
        num_clusters=clusters.num_clusters,
        cluster_sizes=clusters.sizes,
    )
