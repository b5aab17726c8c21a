"""Stereo camera model: disparity <-> depth, Q-matrix reprojection.

Counterpart of ``perception_tpu/geometry/stereo.py``, after
``vision_opencv/image_geometry``'s ``StereoCameraModel``
(``stereo_camera_model.cpp``): the rectified pair defined by the left
pinhole intrinsics and the baseline, its 4x4 reprojection matrix Q
(``:53``), per-pixel ``projectDisparityTo3d`` (``:115``) and the dense
``projectDisparityImageTo3d`` with the ``MISSING_Z = 10000`` sentinel for
non-positive disparities (``:130-132``). The intrinsics and the baseline
are float32 values, as the JAX package's leaves; they enter each
computation as tensors on the input's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry.camera import PinholeCamera

MISSING_Z = 10000.0


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    left: PinholeCamera
    baseline: float  # meters (Tx = -fx * baseline in the right P)

    def __post_init__(self):
        object.__setattr__(self, "baseline", float(np.float32(self.baseline)))

    def _q_rows(self):
        f32 = np.float32
        invb = float(f32(1.0) / f32(self.baseline))
        return [
            [1.0, 0.0, 0.0, -self.left.cx],
            [0.0, 1.0, 0.0, -self.left.cy],
            [0.0, 0.0, 0.0, self.left.fx],
            [0.0, 0.0, invb, 0.0],
        ]

    @property
    def Q(self) -> torch.Tensor:
        """Disparity-to-depth reprojection matrix (OpenCV convention),
        float32 on the CPU: [X Y Z W]^T = Q [u v d 1]^T."""
        return torch.tensor(self._q_rows(), dtype=torch.float32)

    def _fb(self) -> float:
        return float(np.float32(self.left.fx) * np.float32(self.baseline))

    def disparity_to_depth(self, disparity: torch.Tensor) -> torch.Tensor:
        """Z = fx * baseline / d; non-positive d -> MISSING_Z."""
        ok = disparity > 0
        z = const(self._fb(), disparity) / torch.where(ok, disparity, torch.ones_like(disparity))
        return torch.where(ok, z, torch.full_like(z, MISSING_Z))

    def project_disparity_to_3d(self, uv: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixels + (...) disparity -> (..., 3) points
        (projectDisparityTo3d semantics)."""
        hom = torch.stack([uv[..., 0], uv[..., 1], disparity, torch.ones_like(disparity)], dim=-1)
        XYZW = hom @ const(self._q_rows(), disparity).T
        W = XYZW[..., 3:]
        pts = XYZW[..., :3] / torch.where(torch.abs(W) > 1e-12, W, torch.full_like(W, 1e-12))
        ok = disparity[..., None] > 0
        return torch.where(ok, pts, const([0.0, 0.0, MISSING_Z], disparity))

    def disparity_image_to_3d(self, disparity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, W) disparity -> ((H, W, 3) points, (H, W) valid mask)."""
        H, W = disparity.shape
        vv, uu = torch.meshgrid(
            torch.arange(H, dtype=disparity.dtype, device=disparity.device),
            torch.arange(W, dtype=disparity.dtype, device=disparity.device),
            indexing="ij",
        )
        pts = self.project_disparity_to_3d(torch.stack([uu, vv], dim=-1), disparity)
        return pts, disparity > 0

    def depth_to_disparity(self, depth: torch.Tensor) -> torch.Tensor:
        return const(self._fb(), depth) / torch.clamp(depth, min=1e-9)
