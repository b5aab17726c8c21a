"""Cuboid-frame estimation from orthogonal face fits.

Counterpart of ``perception_tpu/models/surface_frame.py``, the reference's
surface-normal node (``cuboid_detection/src/surface_normal_estimation.cpp``):
given the segmented off-plane (box) cloud and the ground-plane normal,
RANSAC three orthogonal faces, one perpendicular to the ground normal (the
top face, ``SACMODEL_PERPENDICULAR_PLANE``) and two parallel to it (the
sides, ``SACMODEL_PARALLEL_PLANE``), removing inliers between fits
(``getNormal`` loop ``:105-165``, ``:182-194``); then

  * sort the planes by inlier count (``:196-210``);
  * orthonormalize and make the frame right-handed (``:212-215``);
  * take the cloud centroid as the frame origin (``:217-219``);
  * assemble the 4x4 pose (``:221-225``).

Each fit scores its hypotheses through the fused RANSAC kernel (K1), so a
call launches it three times on the card; each fit's refit reads the card
once (its eigh).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import points as P
from perception_tpu_torch.ops.ransac import ransac_plane


class SurfaceFrame(NamedTuple):
    pose: torch.Tensor           # (4, 4) camera -> estimated_cuboid_frame
    face_normals: torch.Tensor   # (3, 4) plane coefficients, inlier-count order
    inlier_counts: torch.Tensor  # (3,) int32
    valid: torch.Tensor          # () bool: all three fits usable


def estimate_surface_frame(
    points: torch.Tensor,
    mask: torch.Tensor,
    ground_normal: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold: float = 0.008,
    eps_angle: float = 0.1,
    num_hypotheses: int = 512,
    indices: Optional[Sequence[torch.Tensor]] = None,
) -> SurfaceFrame:
    """Box cloud (N, 3) with mask (N,) and the ground normal (3,) -> frame.

    Triplets come from ``generator``, or from ``indices``: three
    (num_hypotheses, 3) row tensors, one per fit, in the place of the JAX
    package's ``jax.random.split(key, 3)``."""
    if indices is None:
        indices = (None, None, None)
    kw = dict(threshold=threshold, num_hypotheses=num_hypotheses, axis=ground_normal, eps_angle=eps_angle)
    # Face 1: perpendicular to the ground normal (normal ~ ground normal).
    fit1 = ransac_plane(points, mask, generator, model="perpendicular", indices=indices[0], **kw)
    m = mask & ~fit1.inliers
    # Faces 2, 3: parallel to the ground normal (side faces), removing
    # each fit's inliers, as the reference's loop does.
    fit2 = ransac_plane(points, m, generator, model="parallel", indices=indices[1], **kw)
    m = m & ~fit2.inliers
    fit3 = ransac_plane(points, m, generator, model="parallel", indices=indices[2], **kw)

    coeffs = torch.stack([fit1.coefficients, fit2.coefficients, fit3.coefficients])
    counts = torch.stack([fit1.num_inliers, fit2.num_inliers, fit3.num_inliers])

    # Faces by inlier count, descending (surface_normal_estimation.cpp:196-210).
    order = torch.argsort(-counts, stable=True)
    coeffs = coeffs[order]
    counts = counts[order]

    n0 = coeffs[0, :3]
    n1 = coeffs[1, :3]
    # Gram-Schmidt: x = n0, y = n1 orthogonalized, z = x cross y (right-handed).
    x = n0 / torch.clamp(torch.linalg.vector_norm(n0), min=1e-12)
    y = n1 - torch.dot(n1, x) * x
    y = y / torch.clamp(torch.linalg.vector_norm(y), min=1e-12)
    z = torch.linalg.cross(x, y)
    R = torch.stack([x, y, z], dim=1)  # columns are the frame axes

    origin = P.centroid(points, mask)
    pose = se3.make_T(R, origin)
    valid = fit1.valid & fit2.valid & fit3.valid
    return SurfaceFrame(pose=pose, face_normals=coeffs, inlier_counts=counts, valid=valid)
