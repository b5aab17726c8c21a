"""Face landmarks: the crop-heatmap decode.

Counterpart of ``decode_landmarks`` in ``perception_tpu/models/face.py``,
which the hand path shares with the face path. The rest of the face
module (the landmark net, detection, head pose, gaze and action units)
is not ported yet.
"""

from __future__ import annotations

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.heatmap import nms_heatmap


def decode_landmarks(heatmaps: torch.Tensor, crop_box: torch.Tensor, threshold: float = 0.05):
    """(..., C, H', W') crop heatmaps (channel-first, as the port's nets
    give them) + (..., 4) crop boxes -> (..., C, 2) image-space landmarks,
    (..., C) validity and (..., C) peak scores, mapping each channel's
    best peak through its crop box."""
    peaks = nms_heatmap(heatmaps, threshold=threshold, max_peaks=1)
    xy = peaks.xy[..., 0, :]  # (..., C, 2) in heatmap coords
    Hh, Wh = heatmaps.shape[-2:]
    x1, y1, x2, y2 = (crop_box[..., i:i + 1] for i in range(4))
    sx = (x2 - x1) / const(float(Wh), crop_box)
    sy = (y2 - y1) / const(float(Hh), crop_box)
    img_xy = torch.stack([x1 + (xy[..., 0] + 0.5) * sx, y1 + (xy[..., 1] + 0.5) * sy], dim=-1)
    return img_xy, peaks.mask[..., 0], peaks.score[..., 0]
