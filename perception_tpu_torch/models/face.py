"""Face analysis: boxes, landmarks, head pose, gaze, action units.

Counterpart of ``perception_tpu/models/face.py``:

* ``face_roi_from_pose``, ``iou`` and ``non_overlapping_detections``:
  the face box from body keypoints and the IoU dedup of candidate boxes
  against live tracks;
* ``FaceLandmarkNet``: the 70-landmark heatmap CNN on a face crop,
  channel-first (NCHW) where flax is NHWC, and ``decode_landmarks``, the
  crop-heatmap decode the hand path shares;
* ``head_pose_pnp``: the 6-DoF head pose by Gauss-Newton from both
  initial orientations;
* ``gaze_from_landmarks``, ``ActionUnitHead``, ``normalize_landmarks``
  and ``au_gated_pose_mask``.

The JAX package maps these over a face axis with ``vmap``; here every
function takes leading batch dimensions instead, so the slots of
``models/face_multi`` go through one call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perception_tpu_torch._tensor import const, consts
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops.heatmap import nms_heatmap

NUM_FACE_LANDMARKS = 70  # 68 + 2 pupils (OpenPose face model)

AU_NAMES = [
    "AU01", "AU02", "AU04", "AU05", "AU06", "AU07", "AU09", "AU10",
    "AU12", "AU14", "AU15", "AU17", "AU20", "AU23", "AU25", "AU26", "AU45",
]

# Rigid 3-D face model (metres, head frame: x right, y down, z forward out
# of the face) for the PnP landmarks: nose tip (30), chin (8), eye outer
# corners (36, 45), mouth corners (48, 54).
PNP_LANDMARK_IDS = np.array([30, 8, 36, 45, 48, 54], np.int32)
PNP_MODEL_POINTS = np.array(
    [
        (0.0, 0.0, 0.0),          # nose tip
        (0.0, 0.066, -0.013),     # chin
        (-0.045, -0.034, -0.027), # right eye outer corner (image-left)
        (0.045, -0.034, -0.027),  # left eye outer corner
        (-0.029, 0.033, -0.024),  # mouth right
        (0.029, 0.033, -0.024),   # mouth left
    ],
    np.float32,
)

RIGHT_EYE_RING = np.arange(36, 42)
LEFT_EYE_RING = np.arange(42, 48)
RIGHT_PUPIL, LEFT_PUPIL = 68, 69


def face_roi_from_pose(keypoints: torch.Tensor, part_ids=(0, 15, 16, 17, 18)) -> torch.Tensor:
    """Body keypoints (..., P, 3) -> face boxes (..., 4) (x1, y1, x2, y2):
    a square of half size max(1.5 x the nose/eyes/ears spread, 8) around
    their centre (BODY_25 ids)."""
    ids = torch.tensor(part_ids).to(keypoints.device, non_blocking=True)
    sel = keypoints.index_select(-2, ids)
    pts, w = sel[..., :2], (sel[..., 2] > 0).to(keypoints.dtype)
    cnt = torch.clamp(w.sum(-1), min=1.0)[..., None]
    c = (pts * w[..., None]).sum(-2) / cnt
    spread = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(-1).mul(w).sum(-1, keepdim=True) / cnt)
    half = torch.clamp(spread * 1.5, min=8.0)
    return torch.cat([c - half, c + half], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes (..., 4) against (..., 4), broadcast."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def non_overlapping_detections(track_boxes, track_mask, det_boxes, det_mask, threshold: float = 0.5):
    """(D,) mask: the detections whose IoU with every live track is <= threshold."""
    ious = iou(det_boxes[:, None, :], track_boxes[None, :, :])  # (D, T)
    clash = ((ious > threshold) & track_mask[None, :]).any(dim=1)
    return det_mask & ~clash


class FaceLandmarkNet(nn.Module):
    """Heatmap CNN on a crop: (N, C, S, S) -> (N, 70, S/4, S/4): two blocks
    of (conv, conv, 2x2 max-pool), a conv, a 1x1 head. flax's ``Conv_0`` to
    ``Conv_4`` are ``convs``, ``Conv_5`` the ``head``. TF32: see
    ``models/pose.PoseNet``."""

    def __init__(self, width: int = 64, in_channels: int = 1, num_landmarks: int = NUM_FACE_LANDMARKS):
        super().__init__()
        w = width
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, w, 3, padding=1), nn.Conv2d(w, w, 3, padding=1),
            nn.Conv2d(w, 2 * w, 3, padding=1), nn.Conv2d(2 * w, 2 * w, 3, padding=1),
            nn.Conv2d(2 * w, 2 * w, 3, padding=1),
        ])
        self.head = nn.Conv2d(2 * w, num_landmarks, 1)

    def forward(self, x):
        c = self.convs
        for i in (0, 2):
            x = F.relu(c[i + 1](F.relu(c[i](x))))
            x = F.max_pool2d(x, 2)
        x = F.relu(c[4](x))
        return self.head(x)


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


def _project(T, X, fx, fy, cx, cy):
    """Model points X (6, 3) under poses T (..., 4, 4) -> (camera points
    (..., 6, 3), depth clamped at 1e-6 (..., 6), pixels (..., 6, 2))."""
    pc = se3.transform_points(T, X)
    z = torch.clamp(pc[..., 2], min=1e-6)
    pred = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)
    return pc, z, pred


def head_pose_pnp(landmarks: torch.Tensor, lm_mask: torch.Tensor, fx, fy, cx, cy,
                  iterations: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Landmarks (..., 70, 2) + mask (..., 70) -> head pose (camera <- head,
    (..., 4, 4)) and mean reprojection error (...), by ``iterations``
    Gauss-Newton steps on the 6-point rigid model.

    GN runs from both initial orientations, identity and the y-flip (the
    subject facing the camera), as one batch over a branch axis: the model
    is near-planar enough that the wrong start converges to the mirror
    solution. The branch with the lower finite error wins (the first on a
    tie); a diverged branch's NaN never does. Intrinsics are numbers or
    0-dim tensors; the 6x6 systems go through ``solve_ex`` (no host sync).
    """
    ref = landmarks
    fx, fy, cx, cy = consts(ref, fx, fy, cx, cy)
    ids = torch.from_numpy(PNP_LANDMARK_IDS.astype(np.int64)).to(ref.device, non_blocking=True)
    uv = landmarks.index_select(-2, ids)[..., None, :, :]                    # (..., 1, 6, 2)
    w = lm_mask.index_select(-1, ids).to(ref.dtype)[..., None, :]            # (..., 1, 6)
    X = torch.from_numpy(PNP_MODEL_POINTS).to(ref.device, non_blocking=True)

    z0 = 0.6
    mean_uv = (uv * w[..., None]).sum(-2) / torch.clamp(w.sum(-1, keepdim=True), min=1.0)  # (..., 1, 2)
    t0 = torch.stack([(mean_uv[..., 0] - cx) / fx * z0, (mean_uv[..., 1] - cy) / fy * z0,
                      torch.full_like(mean_uv[..., 0], z0)], dim=-1)        # (..., 1, 3)
    R_flip = se3.so3_exp(const([0.0, float(np.pi), 0.0], ref))
    R0 = torch.stack([torch.eye(3, dtype=ref.dtype, device=ref.device), R_flip])  # (2, 3, 3)
    T = se3.make_T(R0, t0)                                                   # (..., 2, 4, 4)

    eye3 = torch.eye(3, dtype=ref.dtype, device=ref.device)
    damp = 1e-4 * torch.eye(6, dtype=ref.dtype, device=ref.device)
    for _ in range(iterations):
        pc, z, pred = _project(T, X, fx, fy, cx, cy)
        r = (pred - uv) * w[..., None]                                       # (..., 2, 6, 2)
        zero = torch.zeros_like(z)
        Jproj = torch.stack([
            torch.stack([fx / z, zero, -fx * pc[..., 0] / (z * z)], dim=-1),
            torch.stack([zero, fy / z, -fy * pc[..., 1] / (z * z)], dim=-1),
        ], dim=-2)                                                           # (..., 2, 6, 2, 3)
        dpc = torch.cat([eye3.expand(pc.shape + (3,)), -se3.hat(pc)], dim=-1)  # (..., 2, 6, 3, 6)
        J = (Jproj @ dpc) * w[..., None, None]                               # (..., 2, 6, 2, 6)
        J = J.flatten(-3, -2)                                                # (..., 2, 12, 6)
        H = J.transpose(-1, -2) @ J + damp
        g = -(J.transpose(-1, -2) @ r.flatten(-2, -1)[..., None])
        dxi = torch.linalg.solve_ex(H, g)[0][..., 0]
        T = se3.se3_exp(dxi) @ T

    _, _, pred = _project(T, X, fx, fy, cx, cy)
    err = (torch.linalg.vector_norm(pred - uv, dim=-1) * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))
    best = torch.argmin(err, dim=-1, keepdim=True)                           # (..., 1)
    T_best = torch.take_along_dim(T, best[..., None, None], dim=-3)[..., 0, :, :]
    return T_best, torch.take_along_dim(err, best, dim=-1)[..., 0]


def gaze_from_landmarks(landmarks: torch.Tensor, head_pose: torch.Tensor, fx, fy, cx, cy,
                        eyeball_depth: float = 0.012) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit gaze vectors in the camera frame, right and left (..., 3) each:
    from the eyeball centre (behind the eye ring's centroid, along the
    head's -z) through the pupil, both back-projected at the head's
    depth. The ring mean is its sum times 1/6, as XLA computes it."""
    fx, fy, cx, cy = consts(landmarks, fx, fy, cx, cy)
    z_eye = head_pose[..., 2, 3:4]  # (..., 1)

    def bp(uv):
        return torch.cat([(uv[..., 0:1] - cx) / fx * z_eye, (uv[..., 1:2] - cy) / fy * z_eye, z_eye], dim=-1)

    def eye_gaze(ring_ids, pupil_id):
        ring = landmarks[..., int(ring_ids[0]):int(ring_ids[-1]) + 1, :]
        center_2d = ring.sum(-2) * (1.0 / len(ring_ids))
        center_3d = bp(center_2d) - head_pose[..., :3, 2] * eyeball_depth
        g = bp(landmarks[..., pupil_id, :]) - center_3d
        return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-9)

    return eye_gaze(RIGHT_EYE_RING, RIGHT_PUPIL), eye_gaze(LEFT_EYE_RING, LEFT_PUPIL)


class ActionUnitHead(nn.Module):
    """AU intensities in [0, 5] and presence logits, (..., 17) each, from
    pose-normalised landmarks (..., 70, 2), flattened row-major as
    ``[x0, y0, x1, ...]``. flax's ``Dense_0`` is ``hidden``, ``Dense_1``
    ``intensity``, ``Dense_2`` ``presence``."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.hidden = nn.Linear(2 * NUM_FACE_LANDMARKS, hidden)
        self.intensity = nn.Linear(hidden, len(AU_NAMES))
        self.presence = nn.Linear(hidden, len(AU_NAMES))

    def forward(self, landmarks_norm):
        x = F.relu(self.hidden(landmarks_norm.flatten(-2)))
        return 5.0 * torch.sigmoid(self.intensity(x)), self.presence(x)


def normalize_landmarks(landmarks: torch.Tensor, lm_mask: torch.Tensor) -> torch.Tensor:
    """Translation- and scale-normalise (..., 70, 2) over the valid landmarks."""
    w = lm_mask.to(landmarks.dtype)[..., None]
    n = torch.clamp(w.sum((-2, -1)), min=1.0)[..., None, None]
    c = (landmarks * w).sum(-2, keepdim=True) / n
    d = landmarks - c
    scale = torch.sqrt((d * d * w).sum((-2, -1), keepdim=True) / n)
    return d / torch.clamp(scale, min=1e-6)


def au_gated_pose_mask(intensities: torch.Tensor, au_name: str = "AU02", threshold: float = 2.0) -> torch.Tensor:
    """(...) publish gate: the head pose is emitted while the action unit's
    intensity is above ``threshold`` (the reference's AU02 > 2.0 brow
    raiser gate)."""
    return intensities[..., AU_NAMES.index(au_name)] > threshold
