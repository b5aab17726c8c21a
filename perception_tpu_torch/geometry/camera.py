"""Pinhole camera model + depth backprojection on torch tensors.

Counterpart of ``perception_tpu/geometry/camera.py`` for the cuboid
pipeline's needs: the intrinsics container, its constructors and
``backproject_depth``. Distortion, rectification and binning are later
work (ROADMAP.md, Queue 1).

The intrinsics are kept as Python floats rounded to float32, so the
arithmetic matches the JAX package's float32 leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from perception_tpu_torch._tensor import const


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics (float32 values) and image size; zero distortion."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480

    def __post_init__(self):
        for name in ("fx", "fy", "cx", "cy"):
            object.__setattr__(self, name, _f32(getattr(self, name)))

    @classmethod
    def from_K(cls, K, width: int = 640, height: int = 480) -> "PinholeCamera":
        """From a 3x3 (or flat 9) intrinsic matrix."""
        K = np.asarray(K, np.float32).reshape(3, 3)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=width, height=height)

    @classmethod
    def d435_depth(cls) -> "PinholeCamera":
        return cls.from_K([384.0898742675781, 0.0, 322.4656677246094,
                           0.0, 384.0898742675781, 240.64073181152344,
                           0.0, 0.0, 1.0])

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], np.float32
        )

    def backproject_depth(
        self,
        depth: torch.Tensor,
        min_depth: float = 0.05,
        max_depth: float = 10.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Depth image (..., H, W) meters -> (..., H*W, 3) points + (..., H*W) mask.

        Invalid pixels are parked at the origin, as in the JAX package.
        The intrinsics enter as tensors on the depth's device so the
        division is a true float32 division there too."""
        h, w = depth.shape[-2:]
        dev, dt = depth.device, depth.dtype
        vv, uu = torch.meshgrid(
            torch.arange(h, dtype=dt, device=dev),
            torch.arange(w, dtype=dt, device=dev),
            indexing="ij",
        )
        z = depth.reshape(depth.shape[:-2] + (h * w,))
        u = uu.reshape(-1)
        v = vv.reshape(-1)
        valid = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
        z = torch.where(valid, z, torch.zeros((), dtype=dt, device=dev))
        fx, fy, cx, cy = const([self.fx, self.fy, self.cx, self.cy], depth)
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        return torch.stack([x, y, z], dim=-1), valid
