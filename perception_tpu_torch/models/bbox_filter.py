"""3-D point filtering by a 2-D detection rectangle, and bbox projection.

Counterpart of ``perception_tpu/models/bbox_filter.py``, the equivalent of
two reference nodes:
  * ``cuboid_detection/src/bbox_filter.cpp``: project every cloud point
    through the 3x4 camera projection matrix P and keep those whose pixel
    lands inside the detection Rectangle (``within_bbox`` :30-51, filter
    loop :89-95);
  * ``cuboid_detection/scripts/draw_bbox.py``: project the 8 ICP bbox
    vertices through P . E (extrinsics) for the 2-D overlay (:57-62).
"""

from __future__ import annotations

import torch

from perception_tpu_torch._tensor import const


def project_P(P: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(3, 4) projection matrix, (..., 3) points -> (..., 2) pixels."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    uvw = hom @ P.T
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-12)


def filter_by_rect(points: torch.Tensor, mask: torch.Tensor, P: torch.Tensor, rect_xyxy) -> torch.Tensor:
    """Narrow ``mask`` to points in front of the camera that project inside
    the rectangle (x1, y1, x2, y2), given as numbers or tensors."""
    uv = project_P(P, points)
    x1, y1, x2, y2 = (v.to(points.dtype) if isinstance(v, torch.Tensor) else const(float(v), points)
                      for v in rect_xyxy)
    inside = (uv[..., 0] >= x1) & (uv[..., 0] <= x2) & (uv[..., 1] >= y1) & (uv[..., 1] <= y2)
    return mask & inside & (points[..., 2] > 0)


def project_bbox(P: torch.Tensor, extrinsics: torch.Tensor, bbox_vertices: torch.Tensor) -> torch.Tensor:
    """Depth-frame bbox vertices (8, 3) -> colour-image pixels (8, 2)
    through extrinsics E (4, 4), then projection P (3, 4): the
    ``P @ E @ X`` chain of draw_bbox.py:57-62."""
    hom = torch.cat([bbox_vertices, torch.ones_like(bbox_vertices[:, :1])], dim=-1)
    cam = (hom @ extrinsics.T)[:, :3]
    return project_P(P, cam)
