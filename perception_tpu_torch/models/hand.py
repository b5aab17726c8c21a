"""Hand keypoint estimation: detector-from-pose + 21-landmark net.

Counterpart of ``perception_tpu/models/hand.py``: the hand box comes from
the body's wrist and elbow (it sits beyond the wrist along the forearm),
the image is cropped to it by ``jax.image.scale_and_translate``'s linear
warp (``ops/resize.py``, one warp per box), and a heatmap CNN finds the
21 landmarks on the crop. Every function takes leading batch dimensions,
so both hands of several people go through one crop and one net call.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perception_tpu_torch._tensor import const
from perception_tpu_torch.models.face import decode_landmarks  # same crop decode
from perception_tpu_torch.ops.resize import scale_and_translate

NUM_HAND_LANDMARKS = 21

# BODY_25 ids (MPI_15 has the same): RElbow 3, RWrist 4, LElbow 6, LWrist 7.
RIGHT_ARM = (3, 4)
LEFT_ARM = (6, 7)


def hand_roi_from_pose(keypoints: torch.Tensor, arm=(3, 4), extend: float = 1.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body keypoints (..., P, 3) -> (hand box (..., 4), valid (...)).

    Box centre = wrist + 0.3 * (wrist - elbow); half size = max(extend *
    |elbow - wrist| / 2, 8).
    """
    elbow = keypoints[..., arm[0], :2]
    wrist = keypoints[..., arm[1], :2]
    ok = (keypoints[..., arm[0], 2] > 0) & (keypoints[..., arm[1], 2] > 0)
    d = wrist - elbow
    length = torch.linalg.vector_norm(d, dim=-1)
    center = wrist + 0.3 * d
    half = torch.clamp(extend * length * 0.5, min=8.0)
    box = torch.stack([center[..., 0] - half, center[..., 1] - half,
                       center[..., 0] + half, center[..., 1] + half], dim=-1)
    return box, ok & (length > 1.0)


class HandLandmarkNet(nn.Module):
    """(N, C, S, S) hand crop -> (N, 21, S/4, S/4) heatmaps (channel-first;
    flax's is NHWC). TF32: see ``models/pose.PoseNet``."""

    def __init__(self, width: int = 64, in_channels: int = 1):
        super().__init__()
        w = width
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, w, 3, padding=1), nn.Conv2d(w, w, 3, padding=1),
            nn.Conv2d(w, 2 * w, 3, padding=1), nn.Conv2d(2 * w, 2 * w, 3, padding=1),
            nn.Conv2d(2 * w, 2 * w, 3, padding=1),
        ])
        self.head = nn.Conv2d(2 * w, NUM_HAND_LANDMARKS, 1)

    def forward(self, x):
        c = self.convs
        for i in (0, 2):
            x = F.relu(c[i + 1](F.relu(c[i](x))))
            x = F.max_pool2d(x, 2)
        x = F.relu(c[4](x))
        return self.head(x)


def crop_image(image: torch.Tensor, box: torch.Tensor, out_size: int) -> torch.Tensor:
    """Linear crop of (H, W) or (H, W, C) to (..., out_size, out_size[, C]),
    one crop per (..., 4) float box (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = box.unbind(-1)
    size = const(float(out_size), box)
    scale_x = size / torch.clamp(x2 - x1, min=1e-3)
    scale_y = size / torch.clamp(y2 - y1, min=1e-3)
    img = image if image.dim() == 2 else image.movedim(-1, 0)  # (H, W) or (C, H, W)
    out = scale_and_translate(
        img, (out_size, out_size),
        scale=torch.stack([scale_y, scale_x], dim=-1),
        translation=torch.stack([-y1 * scale_y, -x1 * scale_x], dim=-1),
    )
    return out if image.dim() == 2 else out.movedim(-3, -1)


@torch.no_grad()
def extract_hand(net: HandLandmarkNet, image: torch.Tensor, box: torch.Tensor, crop: int = 64):
    """Crop -> landmark net -> image-space landmarks (..., 21, 2), mask and
    scores for (..., 4) boxes; a gray (H, W) image is one channel."""
    patch = crop_image(image, box, crop)
    patch = patch[..., None] if image.dim() == 2 else patch  # (..., S, S, C)
    lead = box.shape[:-1]
    x = patch.reshape((-1,) + patch.shape[-3:]).movedim(-1, 1).contiguous()
    hm = net(x)
    return decode_landmarks(hm.reshape(lead + hm.shape[1:]), box)
