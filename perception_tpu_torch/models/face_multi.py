"""The multi-face pipeline: tracker slots + the batched per-face chain.

Counterpart of ``perception_tpu/models/face_multi.py``. ``max_faces``
fixed slots: (F, 4) boxes, (F,) active mask, (F,) failure counters.
Detections refresh the live slot they overlap best; fresh detections
fill free slots by rank (the k-th fresh detection takes the k-th free
slot); a slot that fails more than ``MAX_TRACK_FAILS`` frames in a row
is freed. The per-face chain (crop -> landmark CNN -> head-pose PnP ->
gaze -> action units -> AU02 gate) runs over all F slots at once: one
batched crop, one landmark-net call, one batched PnP. No host read.

``multi_face_step``'s ``detect`` is a bool tensor or a host bool. The JAX
package runs the detector every frame and masks its detections with
``detect``; with a host ``False`` the port skips the detector, which
gives the same outputs, since no detection then changes a slot.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from perception_tpu_torch.models import face_fixture as FF
from perception_tpu_torch.models.face import (
    au_gated_pose_mask,
    gaze_from_landmarks,
    head_pose_pnp,
    iou,
    non_overlapping_detections,
    normalize_landmarks,
)
from perception_tpu_torch.models.hand import crop_image

MAX_TRACK_FAILS = 4


class FaceTrackState(NamedTuple):
    """Fixed-capacity tracker slots."""

    boxes: torch.Tensor   # (F, 4) last known face box per slot
    active: torch.Tensor  # (F,) slot holds a live track
    fails: torch.Tensor   # (F,) consecutive extraction failures


def init_tracks(max_faces: int, device="cuda") -> FaceTrackState:
    return FaceTrackState(
        boxes=torch.zeros((max_faces, 4), dtype=torch.float32, device=device),
        active=torch.zeros((max_faces,), dtype=torch.bool, device=device),
        fails=torch.zeros((max_faces,), dtype=torch.int32, device=device),
    )


def assign_detections(state: FaceTrackState, det_boxes: torch.Tensor, det_mask: torch.Tensor,
                      iou_threshold: float = 0.5) -> FaceTrackState:
    """Detections -> slots: each active slot adopts its best-overlapping
    detection above ``iou_threshold`` (``argmax``'s first index), and the
    detections that overlap no active slot fill free slots by rank."""
    ious = iou(det_boxes[:, None, :], state.boxes[None, :, :])  # (D, F)
    scores = torch.where(det_mask[:, None], ious, torch.full_like(ious, -1.0))
    best = torch.argmax(scores, dim=0)                             # (F,)
    best_iou = scores.gather(0, best[None])[0]
    refreshed = state.active & (best_iou > iou_threshold)
    boxes = torch.where(refreshed[:, None], det_boxes.index_select(0, best), state.boxes)

    fresh = non_overlapping_detections(state.boxes, state.active, det_boxes, det_mask, iou_threshold)
    det_rank = torch.cumsum(fresh.int(), 0) - 1                    # (D,)
    free = ~state.active
    slot_rank = torch.cumsum(free.int(), 0) - 1                    # (F,)
    match = fresh[:, None] & free[None, :] & (det_rank[:, None] == slot_rank[None, :])  # (D, F)
    filled = match.any(dim=0)
    src = torch.argmax(match.int(), dim=0)
    boxes = torch.where(filled[:, None], det_boxes.index_select(0, src), boxes)
    return FaceTrackState(
        boxes=boxes,
        active=state.active | filled,
        fails=torch.where(filled | refreshed, torch.zeros_like(state.fails), state.fails),
    )


def retire_failed_tracks(state: FaceTrackState, ok: torch.Tensor) -> FaceTrackState:
    """A slot whose extraction failed counts one more failure (a success
    resets the count); past MAX_TRACK_FAILS in a row the slot is freed."""
    fails = torch.where(state.active & ~ok, state.fails + 1, torch.zeros_like(state.fails))
    return FaceTrackState(boxes=state.boxes, active=state.active & (fails <= MAX_TRACK_FAILS), fails=fails)


@torch.no_grad()
def extract_faces(params: dict, gray: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor, fx, fy, cx, cy,
                  crop: int, ok_landmark_frac: float = 0.6, ok_reproj_px: float = 12.0) -> dict:
    """The per-face chain over the slot axis: gray (H, W) in [0, 255],
    boxes (F, 4), mask (F,). Returns (F, ...) outputs and ``ok``, the
    per-slot success that feeds ``retire_failed_tracks``. Divisions by
    constants are multiplies by their reciprocals, as XLA compiles them."""
    patch = crop_image(gray, boxes, crop) * (1.0 / 255.0)
    uv, m, score = FF.landmarks_from_crop(params["landmark"], patch, boxes)
    T, px_err = head_pose_pnp(uv, m, fx, fy, cx, cy)
    gaze_r, gaze_l = gaze_from_landmarks(uv, T, fx, fy, cx, cy)
    inten, presence = params["au"](normalize_landmarks(uv, m))
    m = m & mask[:, None]
    frac = m.sum(dim=1, dtype=torch.float32) * (1.0 / m.shape[1])
    ok = mask & (frac >= ok_landmark_frac) & (px_err < ok_reproj_px)
    return {
        "boxes": boxes,
        "mask": mask,
        "landmarks": uv,                  # (F, 70, 2)
        "landmark_mask": m,               # (F, 70)
        "landmark_scores": score,         # (F, 70)
        "head_pose": T,                   # (F, 4, 4)
        "reproj_px": px_err,              # (F,)
        "gaze": torch.stack([gaze_r, gaze_l], dim=1),  # (F, 2, 3) [right, left]
        "au_intensities": inten,          # (F, 17)
        "au_presence": presence,          # (F, 17)
        "pose_gate": au_gated_pose_mask(inten) & mask,  # (F,)
        "ok": ok,                         # (F,)
    }


@torch.no_grad()
def multi_face_step(params: dict, gray: torch.Tensor, state: FaceTrackState, fx, fy, cx, cy, detect,
                    crop: int = 96, det_threshold: float = 0.3) -> Tuple[FaceTrackState, dict]:
    """One frame: detect (when ``detect``) -> slot assignment -> batched
    per-face extraction -> failure retirement."""
    if not (isinstance(detect, bool) and not detect):
        det = FF.detect_with_net(params["det"], gray, threshold=det_threshold, max_faces=state.boxes.shape[0])
        state = assign_detections(state, det.boxes, det.mask & detect)
    out = extract_faces(params, gray, state.boxes, state.active, fx, fy, cx, cy, crop)
    return retire_failed_tracks(state, out["ok"]), out
