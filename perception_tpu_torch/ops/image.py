"""2-D image ops.

Counterpart of ``perception_tpu/ops/image.py``. Only ``bilinear_resize``
is ported so far (the face detector's scale pyramid runs it); the colour,
thresholding, morphology and component ops are not.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perception_tpu_torch.ops.resize import resize


def bilinear_resize(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, out_hw + img.shape[2:], "bilinear")`` of an
    (H, W) or (H, W, C) image: antialiased when it downsamples
    (``ops/resize.py``), unlike ``F.interpolate``."""
    if img.dim() == 2:
        return resize(img, out_hw)
    return resize(img.movedim(-1, 0), out_hw).movedim(0, -1)
