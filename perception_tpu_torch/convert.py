"""Turn the JAX package's pipeline state into the port's.

The cuboid pipeline has no weights: its state is the camera and the
preprocessed template (``template_features``' points, normals and mask).
``state_from_jax`` takes them as numpy arrays (``np.asarray`` of the JAX
side's values), so both packages compute on the same state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perception_tpu_torch.geometry.camera import PinholeCamera


class CuboidState(NamedTuple):
    camera: PinholeCamera
    template: torch.Tensor          # (M, 3) float32
    template_normals: torch.Tensor  # (M, 3) float32
    template_mask: torch.Tensor     # (M,) bool


def state_from_jax(
    camera_K, width: int, height: int, template, template_normals, template_mask,
    device="cpu",
) -> CuboidState:
    """Intrinsics (3x3 or flat 9) + image size + template arrays -> CuboidState."""
    return CuboidState(
        camera=PinholeCamera.from_K(camera_K, width=width, height=height),
        template=torch.tensor(np.asarray(template, np.float32), device=device),
        template_normals=torch.tensor(np.asarray(template_normals, np.float32), device=device),
        template_mask=torch.tensor(np.asarray(template_mask, bool), device=device),
    )
