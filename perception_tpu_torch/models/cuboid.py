"""The cuboid-detection pipeline on torch tensors.

Counterpart of ``perception_tpu/models/cuboid.py``:

  depth -> stride-2 decimation + backprojection -> passthrough z/x ->
  compact -> 5 mm voxel downsample -> compact_prefix -> RANSAC ground
  plane -> off-plane compaction -> dominant-blob filter (or the largest
  connected component) -> yaw-restart point-to-plane (or point-to-point)
  ICP against the template -> pose + fitness gate + bbox.

Every stage takes one frame or a batch of B frames. RANSAC scoring (the
fused kernel), RANSAC itself and ICP run the batch as a real dimension
(B * restarts ICP lanes); on the card the point-to-plane ICP replays as
one CUDA graph a batch shape. The sort-based point ops loop over frames
(ROADMAP.md, Queue 2). Randomness comes from an explicit
``torch.Generator``, or the RANSAC triplets are given as ``indices``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch import _graph
from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.io.templates import cuboid_vertices
from perception_tpu_torch.ops import points as P
from perception_tpu_torch.ops.cluster import euclidean_cluster
from perception_tpu_torch.ops.icp import icp_batched, icp_point_to_plane
from perception_tpu_torch.ops.ransac import PlaneFit, ransac_plane
from perception_tpu_torch.utils.profiler import span


@dataclasses.dataclass(frozen=True)
class CuboidConfig:
    """Pipeline parameters; the defaults and their reasons are those of
    the JAX package's ``CuboidConfig``."""

    z_limits: Tuple[float, float] = (0.0, 0.9)
    x_limits: Tuple[float, float] = (-0.2, 0.2)
    voxel_size: float = 0.005
    ransac_hypotheses: int = 1024
    ransac_threshold: float = 0.015
    icp_max_iterations: int = 20
    icp_restarts: int = 4
    icp_mode: str = "p2plane"
    fitness_threshold: float = 4.0e-4
    cluster_filter: str = "blob"   # 'blob' | 'cc' | 'off'
    cluster_tolerance: float = 0.02
    blob_radius: Optional[float] = None  # None -> circumradius + 2 cm
    depth_stride: int = 2
    pre_capacity: int = 16384
    work_capacity: int = 8192
    box_capacity: int = 1024
    template_capacity: int = 1280
    dims: Tuple[float, float, float] = (0.2, 0.1, 0.03)

    @classmethod
    def pcl_parity(cls) -> "CuboidConfig":
        """Reference-budget parity mode: PCL point-to-point ICP with a
        5000-iteration cap, full-resolution depth, connected components."""
        return cls(
            icp_mode="p2p",
            icp_max_iterations=5000,
            depth_stride=1,
            cluster_filter="cc",
            pre_capacity=65536,
        )


class CuboidResult(NamedTuple):
    pose: torch.Tensor            # (..., 4, 4) template -> camera
    fitness: torch.Tensor         # (...,) best ICP fitness (mean sq corr dist)
    accepted: torch.Tensor        # (...,) bool — fitness under the gate, plane & box found
    plane: torch.Tensor           # (..., 4) ground-plane coefficients
    plane_valid: torch.Tensor     # (...,) bool
    bbox: torch.Tensor            # (..., 8, 3) cuboid corners in the camera frame
    num_box_points: torch.Tensor  # (...,) int32 off-plane points used


def _per_frame(fn, points, *rest):
    """Apply a one-frame op to an (N, 3) cloud, or to each frame of a
    (B, N, 3) batch and stack the outputs."""
    if points.dim() == 2:
        return fn(points, *rest)
    outs = [fn(*frame) for frame in zip(points, *rest)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


def _yaw_restart_inits(
    scene_centroid: torch.Tensor, template_centroid: torch.Tensor, k: int, dtype
) -> torch.Tensor:
    """K init transforms (scene->template) per frame: (..., 3) -> (..., K, 4, 4).

    T_i translates the scene centroid onto the template centroid, then
    rotates by 2*pi*i/K about the template z axis through its centroid.
    """
    dev = scene_centroid.device
    angles = torch.arange(k, dtype=dtype, device=dev) * (2.0 * math.pi / k)
    zeros = torch.zeros_like(angles)
    Rz = se3.so3_exp(torch.stack([zeros, zeros, angles], dim=-1))  # (k, 3, 3)
    # p -> Rz (p + t - c_t) + c_t  with t = c_t - c_s
    t_shift = template_centroid - scene_centroid  # (..., 3)
    trans = (template_centroid - (Rz @ template_centroid[:, None])[..., 0]) + (
        Rz @ t_shift[..., None, :, None]
    )[..., 0]
    return se3.make_T(Rz, trans)


def _work_cloud(points, mask, config: CuboidConfig):
    """Compact -> voxel downsample -> compact_prefix of one masked frame."""
    cpts, cm = P.compact(points, mask, config.pre_capacity)
    dpts0, dm0 = P.voxel_downsample(cpts, cm, config.voxel_size)
    return P.compact_prefix(dpts0, dm0, config.work_capacity)


def ransac_input(points, mask, config: CuboidConfig = CuboidConfig()):
    """The cloud RANSAC sees: passthrough z/x, compact, voxel downsample,
    compact_prefix of (N, 3) or (B, N, 3) clouds -> (points, mask) at
    ``work_capacity``. Triplet ``indices`` index its rows."""
    m = P.passthrough(points, mask, 2, *config.z_limits)
    m = P.passthrough(points, m, 0, *config.x_limits)
    return _per_frame(lambda p, k: _work_cloud(p, k, config), points, m)


def segment_ground_plane(
    points: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: CuboidConfig = CuboidConfig(),
    indices: Optional[torch.Tensor] = None,
) -> Tuple[PlaneFit, torch.Tensor, torch.Tensor]:
    """Passthrough + voxel downsample + RANSAC plane of (N, 3) or (B, N, 3)
    clouds; returns (plane_fit, downsampled_points, box_mask), where
    box_mask selects the off-plane (object) points."""
    with span("cuboid.segment_ground_plane"):
        dpts, dm = ransac_input(points, mask, config)
        fit = ransac_plane(
            dpts, dm, generator,
            threshold=config.ransac_threshold,
            num_hypotheses=config.ransac_hypotheses,
            indices=indices,
        )
        return fit, dpts, dm & ~fit.inliers


def template_features(
    template, template_mask, config: CuboidConfig = CuboidConfig(), device="cuda"
):
    """Preprocess a template once per session, in numpy: downsample to the
    pipeline's voxel size, compact to ``template_capacity``, and estimate
    kNN-PCA normals oriented toward the camera. Returns (points, normals,
    mask) tensors on ``device``."""
    pts = np.asarray(template, np.float32)
    mask = np.asarray(template_mask, bool)
    pts = pts[mask]

    # Voxel downsample (centroid per occupied cell).
    keys = np.floor((pts - (-5.0)) / config.voxel_size).astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    first = np.ones(len(k), bool)
    if len(k) > 1:
        first[1:] = (k[1:] != k[:-1]).any(1)
    groups = np.cumsum(first) - 1
    sums = np.zeros((groups[-1] + 1, 3))
    np.add.at(sums, groups, pts[order])
    counts = np.bincount(groups)
    down = (sums / counts[:, None]).astype(np.float32)

    cap = config.template_capacity
    down = down[:cap]
    n = len(down)

    # kNN-PCA normals (k=8).
    d2 = ((down[:, None, :] - down[None, :, :]) ** 2).sum(-1)
    knn_idx = np.argsort(d2, axis=1)[:, :8]
    neigh = down[knn_idx]  # (n, 8, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, evecs = np.linalg.eigh(cov)
    normals = evecs[..., 0]
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    # Orient toward a far viewpoint behind the camera (-z).
    vp = np.array([0.0, 0.0, -10.0]) - down
    flip = (normals * vp).sum(1) < 0
    normals[flip] *= -1

    tpts = np.full((cap, 3), 1.0e6, np.float32)
    tnorm = np.zeros((cap, 3), np.float32)
    tmask = np.zeros(cap, bool)
    tpts[:n] = down
    tnorm[:n] = normals
    tmask[:n] = True
    return tuple(torch.from_numpy(a).to(device) for a in (tpts, tnorm, tmask))


def _restart_icp(icp, box_points, box_mask, template, template_mask, k: int):
    """``icp(sources, masks, inits)`` from K yaw restarts of each scene
    cloud, and the restart of least fitness: (pose, fitness, converged),
    ``pose`` the inverse of its scene->template transform."""
    cs = P.centroid(box_points, box_mask)
    ct = P.centroid(template, template_mask)
    inits = _yaw_restart_inits(cs, ct, k, box_points.dtype)  # (..., k, 4, 4)

    lead = box_points.shape[:-2]
    sources = box_points[..., None, :, :].expand(lead + (k,) + box_points.shape[-2:])
    masks = box_mask[..., None, :].expand(lead + (k,) + box_mask.shape[-1:])
    res = icp(sources, masks, inits)
    best = torch.argmin(res.fitness, dim=-1, keepdim=True)  # (..., 1)
    T_best = torch.take_along_dim(res.transform, best[..., None, None], dim=-3)[..., 0, :, :]
    fitness = torch.take_along_dim(res.fitness, best, dim=-1)[..., 0]
    converged = torch.take_along_dim(res.converged, best, dim=-1)[..., 0]
    return se3.inverse(T_best), fitness, converged


def _pose_p2plane(box_points, box_mask, template, template_mask, template_normals, cfg: CuboidConfig):
    """The yaw restarts' point-to-plane ICP: (pose, fitness, converged).
    A function of tensors and the config that reads nothing back to the
    host and whose inputs fix every shape, so ``_graph.captured`` can
    capture it."""
    def icp(sources, masks, inits):
        return icp_point_to_plane(
            sources, masks, template, template_normals, template_mask, inits,
            max_iterations=cfg.icp_max_iterations,
            transformation_epsilon=1e-12,
        )

    return _restart_icp(icp, box_points, box_mask, template, template_mask, cfg.icp_restarts)


def estimate_cuboid_pose(
    box_points: torch.Tensor,
    box_mask: torch.Tensor,
    template: torch.Tensor,
    template_mask: torch.Tensor,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[torch.Tensor] = None,
):
    """Yaw-restart ICP of (N, 3) or (B, N, 3) scene clouds against the
    template, point-to-plane (``icp_mode="p2plane"``, which needs
    ``template_normals``) or point-to-point (``"p2p"``). Returns (pose,
    fitness, converged); ``pose`` maps template points into the camera
    frame (the inverse of the best scene->template transform).

    Point-to-plane (``_pose_p2plane``) runs through ``_graph.captured``:
    on CUDA tensors one CUDA graph a batch shape, replayed. Point-to-point
    reads ``done.all()`` back to the host, so it runs eagerly."""
    if config.icp_mode == "p2plane" and template_normals is None:
        raise ValueError("template_normals is required: take them from template_features()")
    with span("cuboid.estimate_cuboid_pose"):
        if config.icp_mode == "p2plane":
            inputs = (box_points, box_mask, template, template_mask, template_normals)
            return _graph.captured(_pose_p2plane, inputs, config)

        def icp(sources, masks, inits):
            return icp_batched(
                sources, masks, template, template_mask, init_transforms=inits,
                max_iterations=config.icp_max_iterations,
                transformation_epsilon=1e-9,
            )

        return _restart_icp(icp, box_points, box_mask, template, template_mask, config.icp_restarts)


def cuboid_pipeline_step(
    points: torch.Tensor,
    mask: torch.Tensor,
    template: torch.Tensor,
    template_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> CuboidResult:
    """Full pipeline on an (N, 3) or (B, N, 3) masked cloud; pass a
    template preprocessed by ``template_features`` and its normals."""
    fit, dpts, box_mask = segment_ground_plane(points, mask, generator, config, indices)
    with span("cuboid.box_filter"):
        box_pts, box_m = _per_frame(lambda p, m: P.compact(p, m, config.box_capacity), dpts, box_mask)
        if config.cluster_filter == "cc":
            def largest(p, m):
                cl = euclidean_cluster(p, m, tolerance=config.cluster_tolerance, min_size=1,
                                       max_size=config.box_capacity, max_clusters=8)
                return m & (cl.labels == 0)

            box_m = _per_frame(largest, box_pts, box_m)
            box_pts = P.apply_mask(box_pts, box_m)
        elif config.cluster_filter == "blob":
            radius = config.blob_radius
            if radius is None:
                radius = 0.5 * float(np.linalg.norm(config.dims)) + 0.02
            box_m = _per_frame(lambda p, m: P.dominant_blob_filter(p, m, radius=radius), box_pts, box_m)
            box_pts = P.apply_mask(box_pts, box_m)
    pose, fitness, _ = estimate_cuboid_pose(
        box_pts, box_m, template, template_mask, config,
        template_normals=template_normals,
    )
    num_box = torch.sum(box_m, dim=-1, dtype=torch.int32)
    # PCL's hasConverged() also counts hitting the iteration cap, so the
    # gate reduces to the fitness threshold.
    accepted = (fitness < config.fitness_threshold) & fit.valid & (num_box >= 50)
    verts = const(cuboid_vertices(*config.dims), pose)
    return CuboidResult(
        pose=pose,
        fitness=fitness,
        accepted=accepted,
        plane=fit.coefficients,
        plane_valid=fit.valid,
        bbox=se3.transform_points(pose, verts),
        num_box_points=num_box,
    )


def decimate(depth: torch.Tensor, camera: PinholeCamera, stride: int):
    """Take every ``stride``-th pixel of (..., H, W) depth, offset by
    stride//2 so samples stay centered, with intrinsics scaled in float32."""
    if stride <= 1:
        return depth, camera
    o = stride // 2
    depth = depth[..., o::stride, o::stride]
    s, of = np.float32(stride), np.float32(o)
    camera = dataclasses.replace(
        camera,
        fx=np.float32(camera.fx) / s, fy=np.float32(camera.fy) / s,
        cx=(np.float32(camera.cx) - of) / s, cy=(np.float32(camera.cy) - of) / s,
        width=depth.shape[-1], height=depth.shape[-2],
    )
    return depth, camera


def cuboid_pipeline_from_depth(
    depth: torch.Tensor,
    camera: PinholeCamera,
    template: torch.Tensor,
    template_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> CuboidResult:
    """Depth image (H, W) meters -> CuboidResult."""
    with span("cuboid.pipeline"):
        depth, camera = decimate(depth, camera, config.depth_stride)
        points, mask = camera.backproject_depth(depth)
        return cuboid_pipeline_step(
            points, mask, template, template_mask, generator, config,
            template_normals=template_normals, indices=indices,
        )


def cuboid_pipeline_batch(
    depths: torch.Tensor,
    camera: PinholeCamera,
    template: torch.Tensor,
    template_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    config: CuboidConfig = CuboidConfig(),
    template_normals: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> CuboidResult:
    """Frame-batched pipeline: (B, H, W) depths -> CuboidResult with a
    leading B dim; ``indices`` is (B, ransac_hypotheses, 3) if given."""
    if depths.dim() != 3:
        raise ValueError(f"depths must be (B, H, W), got {tuple(depths.shape)}")
    return cuboid_pipeline_from_depth(
        depths, camera, template, template_mask, generator, config,
        template_normals=template_normals, indices=indices,
    )
