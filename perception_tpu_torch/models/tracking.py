"""Person identity tracking across frames.

Counterpart of ``perception_tpu/models/tracking.py`` (OpenPose's
``PersonIdExtractor``): the previous people's keypoints are propagated
with pyramidal LK, greedily matched to the new detections by mean
keypoint distance, and unmatched detections take free slots with fresh
ids. A fixed-capacity track table; no host read.

The JAX function writes detections into slots with scatters whose
unmatched and padding rows all land on slot T-1 (writing its old value
back), and XLA on the CPU applies duplicate indices in order, so the last
detection aimed at a slot wins. The port resolves each slot's last
writer in detection order first and then gathers, so it gives that
result on the CPU and the card alike, whatever order a scatter would
take. (Because of it, a padding row after a detection matched to slot
T-1 undoes that match, in both packages.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from perception_tpu_torch.ops.lk import lk_track


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_tracks: int = 16
    num_parts: int = 25
    match_threshold_px: float = 40.0   # mean keypoint distance gate
    min_shared_parts: int = 3
    lk_levels: int = 3
    lk_radius: int = 7
    # PersonTracker smoothing: a matched track's parts become
    # smooth_alpha * LK prediction + (1 - smooth_alpha) * detection where
    # both see the part; 0.0 = off (detections overwrite).
    smooth_alpha: float = 0.0


class TrackState(NamedTuple):
    ids: torch.Tensor        # (T,) int32 stable person id (-1 free slot)
    keypoints: torch.Tensor  # (T, P, 2)
    kp_mask: torch.Tensor    # (T, P)
    next_id: torch.Tensor    # () int32


def tracker_init(cfg: TrackerConfig = TrackerConfig(), device="cuda") -> TrackState:
    T, P = cfg.max_tracks, cfg.num_parts
    return TrackState(
        ids=torch.full((T,), -1, dtype=torch.int32, device=device),
        keypoints=torch.zeros((T, P, 2), dtype=torch.float32, device=device),
        kp_mask=torch.zeros((T, P), dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def _last_writer(tgt: torch.Tensor, T: int) -> torch.Tensor:
    """(T,) the last index d with tgt[d] == slot, or -1: what XLA's
    in-order scatter leaves in each slot."""
    D = tgt.shape[0]
    hits = tgt[:, None] == torch.arange(T, device=tgt.device)[None, :]
    return torch.where(hits, torch.arange(D, device=tgt.device)[:, None], -1).amax(dim=0)


@torch.no_grad()
def tracker_step(state: TrackState, prev_gray: torch.Tensor, gray: torch.Tensor, det_keypoints: torch.Tensor,
                 det_mask: torch.Tensor, cfg: TrackerConfig = TrackerConfig()) -> Tuple[TrackState, torch.Tensor]:
    """(D, P, 3) detections (x, y, score) + (D,) mask -> (new state, (D,)
    int32 person id per detection, -1 unmatched)."""
    T, P = cfg.max_tracks, cfg.num_parts
    D = det_keypoints.shape[0]
    dev = det_keypoints.device
    live = state.ids >= 0

    # 1. Propagate live tracks' keypoints with LK.
    flow = lk_track(prev_gray, gray, state.keypoints.reshape(T * P, 2),
                    (state.kp_mask & live[:, None]).reshape(T * P), levels=cfg.lk_levels, radius=cfg.lk_radius)
    prop_kp = flow.points.reshape(T, P, 2)
    prop_mask = flow.valid.reshape(T, P) & state.kp_mask

    det_xy = det_keypoints[..., :2]
    det_part_mask = det_keypoints[..., 2] > 0  # (D, P)

    # 2. Mean distance over the parts both see.
    shared = prop_mask[:, None, :] & det_part_mask[None, :, :]                     # (T, D, P)
    diff = torch.linalg.vector_norm(prop_kp[:, None] - det_xy[None], dim=-1)        # (T, D, P)
    nshared = shared.sum(-1)
    dist = torch.where(shared, diff, torch.zeros_like(diff)).sum(-1) / torch.clamp(nshared, min=1)
    feasible = (live[:, None] & det_mask[None, :] & (nshared >= cfg.min_shared_parts)
                & (dist <= cfg.match_threshold_px))
    cost = torch.where(feasible, dist, torch.full_like(dist, float("inf")))

    # 3. Greedy assignment: min(T, D) trips of the flattened argmin (first
    # index on ties), each striking its track's row and detection's column.
    rows = torch.arange(T, device=dev)[:, None]
    cols = torch.arange(D, device=dev)[None, :]
    track_of_det = torch.full((D,), -1, dtype=torch.int64, device=dev)
    for _ in range(min(T, D)):
        best = torch.argmin(cost.reshape(-1), dim=0, keepdim=True)
        ti, di = torch.div(best, D, rounding_mode="floor"), best % D
        hit = torch.isfinite(cost.reshape(-1).gather(0, best))
        track_of_det = torch.where((cols[0] == di) & hit, ti, track_of_det)
        cost = torch.where((rows == ti) | (cols == di), torch.full_like(cost, float("inf")), cost)

    # 4. The k-th unmatched detection takes the k-th free slot (a stable
    # argsort puts free slots first, in order) with a fresh id.
    free = ~live
    unmatched = det_mask & (track_of_det < 0)
    new_rank = torch.cumsum(unmatched.long(), 0) - 1                                # (D,)
    slot_order = torch.argsort((~free).int(), stable=True)
    det_slot = torch.where(unmatched & (new_rank < free.sum()),
                           slot_order.index_select(0, torch.clamp(new_rank, 0, T - 1)), -1)
    track_of_det = torch.where(det_slot >= 0, det_slot, track_of_det)
    new_ids_for_det = state.next_id + new_rank.int()

    # 5. Write the detections into their tracks; unmatched and padding rows
    # aim at slot T-1 and carry its old values (see the module docstring).
    matched = track_of_det >= 0
    tgt = torch.where(matched, track_of_det, T - 1)
    if cfg.smooth_alpha > 0.0:
        both = (prop_mask.index_select(0, tgt) & det_part_mask)[..., None]
        det_xy = torch.where(both, cfg.smooth_alpha * prop_kp.index_select(0, tgt)
                             + (1.0 - cfg.smooth_alpha) * det_xy, det_xy)
    old_ids = state.ids.index_select(0, tgt)
    vals_ids = torch.where(matched, torch.where(det_slot >= 0, new_ids_for_det, old_ids), old_ids)
    vals_kp = torch.where(matched[:, None, None], det_xy, state.keypoints.index_select(0, tgt))
    vals_km = torch.where(matched[:, None], det_part_mask, state.kp_mask.index_select(0, tgt))

    owner = _last_writer(tgt, T)
    written = owner >= 0
    src = torch.clamp(owner, min=0)
    new_ids = torch.where(written, vals_ids.index_select(0, src), state.ids)
    kp = torch.where(written[:, None, None], vals_kp.index_select(0, src), state.keypoints)
    km = torch.where(written[:, None], vals_km.index_select(0, src), state.kp_mask)

    # Tracks that matched nothing keep the LK propagation.
    matched_track = written & matched.index_select(0, src)
    kp = torch.where(matched_track[:, None, None], kp, prop_kp)
    km = torch.where(matched_track[:, None], km, prop_mask)

    new_state = TrackState(ids=new_ids, keypoints=kp, kp_mask=km,
                           next_id=state.next_id + (det_slot >= 0).sum().int())
    person_ids = torch.where(matched, new_ids.index_select(0, torch.clamp(track_of_det, 0, T - 1)), -1)
    return new_state, person_ids.int()
