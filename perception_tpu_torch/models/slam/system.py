"""Full keyframe SLAM system: dense odometry + landmark tracks + local
BA + sparse loop closure + pose-graph correction.

Counterpart of ``perception_tpu/models/slam/system.py``. All state lives
on the device in fixed-capacity NamedTuples of tensors:

  depth, gray -> odometry_step (point-to-plane ICP against the current
                 keyframe or the fused map, models/slam/odometry.py)
      | promoted?
      v
  KeyframeStore ring: poses, FAST/BRIEF keypoints with pixel coords,
  3-D backprojections and per-feature landmark ids
      | on promotion
      v
  landmark tracks (new keyframe matched against the current one; cumsum
  landmark ids; observation ring), loop-closure probe (Hamming match
  against every stored keyframe, rigid RANSAC, PnP polish), pose-graph
  GN on a verified closure, sliding-window local BA.

The JAX package jits the step, and its three ``lax.cond``s become host
branches here. These are the only host reads of ``slam_step`` (each
through ``_read_flag``):

- ``promoted``, once per frame: a tracking frame returns the state with
  its new odometry and nothing else changed (what the JAX package's
  masked writes leave on such a frame), so it reads nothing more;
- ``loop_ok`` (with ``correct_in_step``) and ``do_ba`` (with
  ``enable_ba``), on promotion frames only.

In map mode odometry reads its own ``promote`` once per frame on top
(models/slam/odometry.py). Nothing else waits for the card, apart from
what a library call does inside: ``torch.linalg.svd`` in the rigid fit
(ops/registration.py) on promotion frames.

``slam_step`` takes a ``torch.Generator`` where the JAX package takes a
key; the RANSAC triplets of the loop-closure probe are drawn by
``_draw_triplets``, the one place the generator is used.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from perception_tpu_torch._tensor import const, row
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam.backend import (
    BAProblem,
    PoseGraph,
    bundle_adjust,
    optimize_pose_graph,
)
from perception_tpu_torch.models.slam.odometry import (
    OdometryConfig,
    OdometryState,
    init_state as odom_init,
    odometry_step,
)
from perception_tpu_torch.ops.features import brief_describe, fast_detect, match_descriptors
from perception_tpu_torch.ops.pnp import pnp_gn
from perception_tpu_torch.ops.ransac import _sample_indices
from perception_tpu_torch.ops.registration import ransac_rigid


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The JAX package's fields and defaults; its comments carry the
    measurements behind each default."""

    odometry: OdometryConfig = OdometryConfig()
    max_keyframes: int = 64
    max_edges: int = 160
    features_per_kf: int = 256
    fast_threshold: float = 25.0
    # Loop closure gates
    lc_min_gap: int = 3              # skip adjacent keyframes
    lc_min_matches: int = 25
    lc_ransac_threshold: float = 0.05
    lc_min_inliers: int = 12
    # Reprojection-PnP refinement of the verified closure transform,
    # accepted only as a small polish of the rigid fit.
    lc_pnp_refine: bool = True
    lc_pnp_max_px: float = 8.0
    lc_pnp_max_dev_m: float = 0.03
    lc_pnp_max_dev_rad: float = 0.05
    # Pose-graph correction inside slam_step on closure frames.
    correct_in_step: bool = True
    pg_iterations: int = 10
    # Sliding-window local BA.
    enable_ba: bool = True
    ba_window: int = 5               # keyframes in the window
    max_landmarks: int = 1024        # landmark ring capacity
    max_observations: int = 4096     # observation ring capacity
    ba_iterations: int = 4
    ba_min_obs: int = 24             # window observations needed to fire
    ba_huber_px: float = 4.0
    ba_damping: float = 1e-3
    ba_depth_weight: float = 1.0     # depth residual vs the fx/z px-per-m scale
    track_gate_m: float = 0.05       # 3-D agreement gate on track extension


class KeyframeStore(NamedTuple):
    poses: torch.Tensor    # (K, 4, 4) world <- kf camera
    desc: torch.Tensor     # (K, F, 8) int32 BRIEF words
    kp_uv: torch.Tensor    # (K, F, 2) keypoint pixel coords
    kp_xyz: torch.Tensor   # (K, F, 3) keypoint 3-D points, kf camera frame
    kp_mask: torch.Tensor  # (K, F) depth-valid keypoints
    lm_id: torch.Tensor    # (K, F) int32 landmark id per feature (-1 none)
    valid: torch.Tensor    # (K,)
    stamp: torch.Tensor    # (K,) int32 insertion sequence number (-1 = never)
    count: torch.Tensor    # () int32 total insertions (ring write head = count % K)


class LandmarkTable(NamedTuple):
    xyz: torch.Tensor     # (L, 3) world positions
    anchor: torch.Tensor  # (L,) int32 keyframe slot of the first observation
    mask: torch.Tensor    # (L,)
    count: torch.Tensor   # () int32 ring write head


class ObsTable(NamedTuple):
    kf: torch.Tensor      # (O,) int32 keyframe slot
    lm: torch.Tensor      # (O,) int32 landmark id
    uv: torch.Tensor      # (O, 2) measured pixels
    z: torch.Tensor       # (O,) measured depth (m; 0 = no depth)
    zw: torch.Tensor      # (O,) depth-residual weight (px/m; 0 = uv-only)
    mask: torch.Tensor    # (O,)
    count: torch.Tensor   # () int32 ring write head


class EdgeList(NamedTuple):
    i: torch.Tensor       # (E,) int32
    j: torch.Tensor       # (E,) int32
    T: torch.Tensor       # (E, 4, 4)
    weight: torch.Tensor  # (E,)
    mask: torch.Tensor    # (E,)
    count: torch.Tensor   # () int32


class SlamState(NamedTuple):
    odom: OdometryState
    keyframes: KeyframeStore
    landmarks: LandmarkTable
    obs: ObsTable
    edges: EdgeList
    current_kf: torch.Tensor  # () int32 index of the active keyframe
    loop_found: torch.Tensor  # () bool: a closure was added this step


class SlamDiag(NamedTuple):
    promoted: torch.Tensor
    loop_candidate: torch.Tensor  # () int32 candidate kf (-1 none)
    loop_matches: torch.Tensor
    loop_inliers: torch.Tensor
    overlap: torch.Tensor
    ba_ran: torch.Tensor          # () bool: local BA fired this step
    ba_cost0: torch.Tensor        # () mean sq reprojection error before (px^2)
    ba_cost1: torch.Tensor        # () after


def _read_flag(flag: torch.Tensor) -> bool:
    """The step's host reads, each a wait for the card."""
    return bool(flag)


def _draw_triplets(generator: torch.Generator, mask: torch.Tensor, num: int) -> torch.Tensor:
    """The loop-closure RANSAC's (num, 3) triplets, uniform over ``mask``."""
    return _sample_indices(generator, mask, num)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def _as(x: torch.Tensor, val) -> torch.Tensor:
    """``val`` as a tensor like ``x``; a Python scalar is filled on the
    device (``torch.as_tensor`` would copy it from the host and wait)."""
    if isinstance(val, torch.Tensor):
        return val.to(x.dtype)
    return torch.full((), val, dtype=x.dtype, device=x.device)


def _put(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x with rows ``idx`` (distinct) set to ``val``."""
    return x.index_put((idx.long(),), _as(x, val))


def _put_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for idx in [0, len(x)]: writes
    to index len(x) land in a scratch row that is sliced off."""
    return _put(torch.cat([x, x[:1]]), idx, val)[:-1]


def _put_if(x: torch.Tensor, idx: torch.Tensor, val, cond: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (one, shape (1,)) set to ``val`` where ``cond``, kept otherwise."""
    return _put(x, idx, torch.where(cond, _as(x, val), x[idx.long()]))


def _kf_features(camera: PinholeCamera, depth, gray, cfg: SlamConfig):
    """Sparse features of a frame for the loop-closure/BA store:
    (descriptors, pixel uv, camera-frame xyz, depth-valid mask).

    The ray goes through the keypoint's pixel uv with its nearest pixel's
    depth; the intrinsics are tensors, so the division is a true one (the
    JAX package's are traced leaves)."""
    kps = fast_detect(gray, threshold=cfg.fast_threshold, max_keypoints=cfg.features_per_kf)
    desc = brief_describe(gray, kps)
    u = torch.clamp(torch.round(kps.uv[:, 0]).long(), 0, camera.width - 1)
    v = torch.clamp(torch.round(kps.uv[:, 1]).long(), 0, camera.height - 1)
    z = depth[v, u]
    ok = kps.mask & torch.isfinite(z) & (z > 0.1)
    z = torch.where(ok, z, torch.zeros((), device=z.device))
    fx, fy, cx, cy = const([camera.fx, camera.fy, camera.cx, camera.cy], depth)
    x = (kps.uv[:, 0] - cx) / fx * z
    y = (kps.uv[:, 1] - cy) / fy * z
    return desc, kps.uv, torch.stack([x, y, z], dim=-1), ok


def slam_init(camera: PinholeCamera, depth0: torch.Tensor, gray0: torch.Tensor,
              cfg: SlamConfig = SlamConfig()) -> SlamState:
    """The first frame is keyframe 0 at the identity; every table is empty."""
    dev = depth0.device
    odom = odom_init(camera, depth0, cfg.odometry)
    K, F, E = cfg.max_keyframes, cfg.features_per_kf, cfg.max_edges
    L, O = cfg.max_landmarks, cfg.max_observations
    # One promotion appends at most 2F observations; ring positions must
    # be unique within a single step's write.
    if 2 * F > O:
        raise ValueError("max_observations must be >= 2 * features_per_kf")
    desc0, uv0, xyz0, m0 = _kf_features(camera, depth0, gray0, cfg)
    i32, f32 = torch.int32, torch.float32

    def first_row(shape, dtype, row):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        t[0] = row
        return t

    kf = KeyframeStore(
        poses=torch.eye(4, device=dev).repeat(K, 1, 1),
        desc=first_row((K, F, 8), i32, desc0),
        kp_uv=first_row((K, F, 2), f32, uv0),
        kp_xyz=first_row((K, F, 3), f32, xyz0),
        kp_mask=first_row((K, F), torch.bool, m0),
        lm_id=torch.full((K, F), -1, dtype=i32, device=dev),
        valid=first_row((K,), torch.bool, True),
        stamp=torch.cat([torch.zeros(1, dtype=i32, device=dev), torch.full((K - 1,), -1, dtype=i32, device=dev)]),
        count=_scalar(1, i32, dev),
    )
    landmarks = LandmarkTable(
        xyz=torch.zeros((L, 3), device=dev),
        anchor=torch.zeros(L, dtype=i32, device=dev),
        mask=torch.zeros(L, dtype=torch.bool, device=dev),
        count=_scalar(0, i32, dev),
    )
    obs = ObsTable(
        kf=torch.zeros(O, dtype=i32, device=dev),
        lm=torch.zeros(O, dtype=i32, device=dev),
        uv=torch.zeros((O, 2), device=dev),
        z=torch.zeros(O, device=dev),
        zw=torch.zeros(O, device=dev),
        mask=torch.zeros(O, dtype=torch.bool, device=dev),
        count=_scalar(0, i32, dev),
    )
    edges = EdgeList(
        i=torch.zeros(E, dtype=i32, device=dev),
        j=torch.zeros(E, dtype=i32, device=dev),
        T=torch.eye(4, device=dev).repeat(E, 1, 1),
        weight=torch.zeros(E, device=dev),
        mask=torch.zeros(E, dtype=torch.bool, device=dev),
        count=_scalar(0, i32, dev),
    )
    return SlamState(odom=odom, keyframes=kf, landmarks=landmarks, obs=obs, edges=edges,
                     current_kf=_scalar(0, i32, dev), loop_found=_scalar(False, torch.bool, dev))


def _probe(state: SlamState, camera: PinholeCamera, depth, gray, generator: torch.Generator,
           slot, cfg: SlamConfig):
    """Promotion-only front end: the new keyframe's features, its matches
    against every stored keyframe (the current one's feed the tracks),
    and the loop-closure candidate's verified transform."""
    kf, cur = state.keyframes, state.current_kf
    K, F = cfg.max_keyframes, cfg.features_per_kf
    desc, uv, xyz, kpm = _kf_features(camera, depth, gray, cfg)

    m = match_descriptors(desc.expand(K, F, 8), kpm.expand(K, F), kf.desc, kf.kp_mask, max_matches=F)
    ia, ib, mm = m.idx_a.long(), m.idx_b.long(), m.mask  # (K, F)
    match_counts = torch.sum(mm, dim=1, dtype=torch.int32)
    kf_idx = torch.arange(K, device=desc.device)
    # Temporal adjacency via insertion stamps (the ring wraps); the new
    # slot and the current keyframe are not eligible.
    eligible = (
        kf.valid
        & (kf.stamp >= 0)
        & (kf.count - kf.stamp >= cfg.lc_min_gap)
        & (kf_idx != slot)
        & (kf_idx != cur)
    )
    match_counts_lc = torch.where(eligible, match_counts, torch.full_like(match_counts, -1))
    cand = torch.argmax(match_counts_lc)
    cand_matches = row(match_counts_lc, cand)

    # Geometric verification: rigid 3D-3D between matched keypoints.
    ia_c, ib_c = row(ia, cand), row(ib, cand)
    src = xyz[ia_c]
    dst = row(kf.kp_xyz, cand)[ib_c]
    pair_mask = row(mm, cand) & kpm[ia_c] & row(kf.kp_mask, cand)[ib_c]
    fit = ransac_rigid(
        src, dst, pair_mask,
        threshold=cfg.lc_ransac_threshold,
        num_hypotheses=128,
        min_inliers=cfg.lc_min_inliers,
        indices=_draw_triplets(generator, pair_mask, 128),
    )
    fit_T = fit.transform
    if cfg.lc_pnp_refine:
        # Polish by reprojection into the candidate keyframe.
        pnp = pnp_gn(src, row(kf.kp_uv, cand)[ib_c], fit.inliers & pair_mask,
                     camera.fx, camera.fy, camera.cx, camera.cy,
                     T_init=fit.transform, iterations=6)
        dev = se3.se3_log(se3.inverse(fit.transform) @ pnp.transform)
        use = (
            fit.valid
            & (pnp.mean_px_error <= cfg.lc_pnp_max_px)
            & (torch.linalg.vector_norm(dev[:3]) <= cfg.lc_pnp_max_dev_m)
            & (torch.linalg.vector_norm(dev[3:]) <= cfg.lc_pnp_max_dev_rad)
        )
        fit_T = torch.where(use, pnp.transform, fit.transform)
    return (desc, uv, xyz, kpm, cand.to(torch.int32), cand_matches, fit_T, fit.num_inliers,
            fit.valid, row(ia, cur), row(ib, cur), row(mm, cur))


def slam_step(
    state: SlamState,
    depth: torch.Tensor,
    gray: torch.Tensor,
    camera: PinholeCamera,
    generator: torch.Generator,
    cfg: SlamConfig = SlamConfig(),
) -> Tuple[SlamState, SlamDiag]:
    """Track one frame; on a promotion also extend the tracks, probe for a
    loop closure, correct the pose graph and run local BA."""
    odom, odiag = odometry_step(state.odom, depth, camera, cfg.odometry)
    dev = depth.device
    i32, f32 = torch.int32, torch.float32
    promoted = odiag.promoted
    if not _read_flag(promoted):
        false = _scalar(False, torch.bool, dev)
        zero = _scalar(0.0, f32, dev)
        return state._replace(odom=odom, loop_found=false), SlamDiag(
            promoted=promoted, loop_candidate=_scalar(-1, i32, dev), loop_matches=_scalar(-1, i32, dev),
            loop_inliers=_scalar(0, i32, dev), overlap=odiag.overlap, ba_ran=false, ba_cost0=zero,
            ba_cost1=zero)

    kf, edges, lm, obs = state.keyframes, state.edges, state.landmarks, state.obs
    cur = state.current_kf
    K, F = cfg.max_keyframes, cfg.features_per_kf
    L, O = cfg.max_landmarks, cfg.max_observations
    # Ring buffer: the write head wraps and evicts the oldest keyframe.
    slot = kf.count % K
    slot1 = slot.reshape(1)
    evict = kf.count >= K

    (desc, uv_new, xyz, kpm, cand, cand_matches, fit_T, fit_inliers, fit_valid,
     i_new, j_cur, mm_cur) = _probe(state, camera, depth, gray, generator, slot, cfg)

    # --- landmark tracks ------------------------------------------------
    # New-kf feature i_new[t] matches current-kf feature j_cur[t]. A match
    # whose current-kf feature carries a landmark id extends that track;
    # otherwise a new landmark is allocated from the current keyframe's
    # depth (cumsum id assignment).
    # Eviction staleness: the recycled slot's observations and the
    # landmarks anchored there go.
    lm_mask0 = lm.mask & ~(evict & (lm.anchor == slot))
    obs_mask0 = obs.mask & ~(evict & (obs.kf == slot))

    cur_xyz = row(kf.kp_xyz, cur)[j_cur]
    cur_ok = row(kf.kp_mask, cur)[j_cur]
    cur_pose = row(kf.poses, cur)
    # Both endpoints need depth, and their world backprojections must
    # agree within track_gate_m.
    x_new_w = se3.transform_points(odom.pose, xyz[i_new])
    x_cur_w = se3.transform_points(cur_pose, cur_xyz)
    agree3d = kpm[i_new] & cur_ok & (torch.linalg.vector_norm(x_new_w - x_cur_w, dim=-1) <= cfg.track_gate_m)
    matched = mm_cur & agree3d
    existing = row(kf.lm_id, cur)[j_cur]
    has_lm = matched & (existing >= 0) & lm_mask0[torch.clamp(existing, 0, L - 1).long()]
    need_new = matched & ~has_lm & cur_ok
    new_ofs = torch.cumsum(need_new.to(i32), dim=0, dtype=i32) - 1
    new_id = (lm.count + new_ofs) % L
    n_new = torch.sum(need_new, dtype=i32)

    # Landmark-ring reallocation: observations of a recycled id belong to
    # the landmark that lived there.
    obs_mask0 = obs_mask0 & ~(((obs.lm - lm.count) % L) < n_new)

    minus1 = torch.full_like(existing, -1)
    lm_id_match = torch.where(has_lm, existing, torch.where(need_new, new_id, minus1))
    widx = torch.where(need_new, new_id, torch.full_like(new_id, L))
    landmarks2 = LandmarkTable(
        xyz=_put_drop(lm.xyz, widx, x_cur_w),
        anchor=_put_drop(lm.anchor, widx, cur),
        mask=_put_drop(lm_mask0, widx, True),
        count=lm.count + n_new,
    )
    # Landmark ids of the new keyframe's slots (i_new is a permutation).
    lm_col = _put(torch.zeros(F, dtype=i32, device=dev), i_new, torch.where(matched, lm_id_match, minus1))

    # Observation ring: up to F at the new keyframe (every live match) and
    # F at the current keyframe (newly created landmarks only).
    obs_kf_c = torch.cat([slot.expand(F), cur.expand(F)]).to(i32)
    obs_lm_c = torch.cat([torch.clamp(lm_id_match, min=0), torch.where(need_new, new_id, torch.zeros_like(new_id))])
    obs_uv_c = torch.cat([uv_new[i_new], row(kf.kp_uv, cur)[j_cur]])
    obs_m_c = torch.cat([matched & (lm_id_match >= 0), need_new])
    obs_z_c = torch.cat([xyz[i_new][:, 2], cur_xyz[:, 2]])
    zval = torch.cat([kpm[i_new], cur_ok])
    # Depth weight w * fx / z: the numerator rounds as float32, the
    # division is a true one (fx is traced in the JAX package's jit).
    zw_num = const(float(np.float32(cfg.ba_depth_weight) * np.float32(camera.fx)), obs_z_c)
    obs_zw_c = torch.where(zval & (obs_z_c > 0.1), zw_num / torch.clamp(obs_z_c, min=0.1),
                           torch.zeros((), device=dev))
    # Valid entries first (stable), so they take consecutive positions.
    order = torch.argsort((~obs_m_c).to(i32), stable=True)
    obs_kf_c, obs_lm_c, obs_uv_c, obs_z_c, obs_zw_c, obs_m_c = (
        t[order] for t in (obs_kf_c, obs_lm_c, obs_uv_c, obs_z_c, obs_zw_c, obs_m_c))
    pos = (obs.count + torch.arange(2 * F, device=dev)) % O
    oidx = torch.where(obs_m_c, pos, torch.full_like(pos, O))
    obs2 = ObsTable(
        kf=_put_drop(obs.kf, oidx, obs_kf_c),
        lm=_put_drop(obs.lm, oidx, obs_lm_c),
        uv=_put_drop(obs.uv, oidx, obs_uv_c),
        z=_put_drop(obs.z, oidx, obs_z_c),
        zw=_put_drop(obs.zw, oidx, obs_zw_c),
        mask=_put_drop(obs_mask0, oidx, True),
        count=obs.count + torch.sum(obs_m_c, dtype=i32),
    )

    # --- keyframe insertion at `slot` ------------------------------------
    kf2 = KeyframeStore(
        poses=_put(kf.poses, slot1, odom.pose[None]),
        desc=_put(kf.desc, slot1, desc[None]),
        kp_uv=_put(kf.kp_uv, slot1, uv_new[None]),
        kp_xyz=_put(kf.kp_xyz, slot1, xyz[None]),
        kp_mask=_put(kf.kp_mask, slot1, kpm[None]),
        lm_id=_put(kf.lm_id, slot1, lm_col[None]),
        valid=_put(kf.valid, slot1, True),
        stamp=_put(kf.stamp, slot1, kf.count.reshape(1)),
        count=kf.count + 1,
    )

    # Eviction invalidates every edge that references the recycled slot.
    stale = evict & ((edges.i == slot) | (edges.j == slot))
    edges = edges._replace(mask=edges.mask & ~stale)

    # --- odometry edge cur -> slot (edge ring) ----------------------------
    e1 = (edges.count % cfg.max_edges).reshape(1)
    T_rel = se3.inverse(cur_pose) @ odom.pose
    edges2 = EdgeList(
        i=_put(edges.i, e1, cur.reshape(1)),
        j=_put(edges.j, e1, slot1),
        T=_put(edges.T, e1, T_rel[None]),
        weight=_put(edges.weight, e1, 1.0),
        mask=_put(edges.mask, e1, True),
        count=edges.count + 1,
    )

    # --- loop closure edge cand -> slot (fit: new-kf -> candidate frame) --
    probe = cand_matches >= cfg.lc_min_matches
    loop_ok = probe & fit_valid
    e2 = (edges2.count % cfg.max_edges).reshape(1)
    edges3 = EdgeList(
        i=_put_if(edges2.i, e2, cand.reshape(1), loop_ok),
        j=_put_if(edges2.j, e2, slot1, loop_ok),
        T=_put_if(edges2.T, e2, fit_T[None], loop_ok),
        weight=_put_if(edges2.weight, e2, 2.0, loop_ok),
        mask=_put_if(edges2.mask, e2, True, loop_ok),
        count=edges2.count + loop_ok.to(i32),
    )

    new_state = SlamState(odom=odom, keyframes=kf2, landmarks=landmarks2, obs=obs2, edges=edges3,
                          current_kf=slot, loop_found=loop_ok)
    if cfg.correct_in_step and _read_flag(loop_ok):
        new_state = correct_with_pose_graph(new_state, iterations=cfg.pg_iterations)

    ba_ran = _scalar(False, torch.bool, dev)
    ba_c0 = ba_c1 = _scalar(0.0, f32, dev)
    if cfg.enable_ba:
        new_state, ba_ran, ba_c0, ba_c1 = _maybe_bundle_adjust(new_state, camera, cfg)

    diag = SlamDiag(
        promoted=promoted,
        loop_candidate=torch.where(probe, cand, torch.full_like(cand, -1)),
        loop_matches=cand_matches,
        loop_inliers=fit_inliers,
        overlap=odiag.overlap,
        ba_ran=ba_ran,
        ba_cost0=ba_c0,
        ba_cost1=ba_c1,
    )
    return new_state, diag


def _maybe_bundle_adjust(state: SlamState, camera: PinholeCamera, cfg: SlamConfig):
    """Sliding-window BA over the last ``ba_window`` keyframes, on a
    promotion frame with enough window observations (one host read of
    ``do_ba``). Returns (state, ba_ran, cost0, cost1)."""
    K = cfg.max_keyframes
    W = min(cfg.ba_window, K)
    L = cfg.max_landmarks
    kf, lm, obs = state.keyframes, state.landmarks, state.obs
    dev = kf.poses.device

    # Window = the W most recent valid keyframes, oldest valid first
    # (bundle_adjust freezes window pose 0, so invalid slots go last).
    stamps = torch.where(kf.valid, kf.stamp, torch.full_like(kf.stamp, -1))
    top_stamp, win_slots = torch.sort(stamps, descending=True, stable=True)
    top_stamp, win_slots = top_stamp[:W], win_slots[:W]
    order = torch.argsort(torch.where(top_stamp >= 0, top_stamp, torch.full_like(top_stamp, 2**30)), stable=True)
    win_slots = win_slots[order]
    win_valid = top_stamp[order] >= 0
    win_of_slot = _put_drop(torch.full((K,), -1, dtype=torch.int32, device=dev),
                            torch.where(win_valid, win_slots, torch.full_like(win_slots, K)),
                            torch.arange(W, dtype=torch.int32, device=dev))

    wp = win_of_slot[torch.clamp(obs.kf, 0, K - 1).long()]
    obs_lm = torch.clamp(obs.lm, 0, L - 1)
    m_obs = obs.mask & (wp >= 0) & lm.mask[obs_lm.long()]
    do_ba = (torch.sum(win_valid, dtype=torch.int32) >= 2) & (torch.sum(m_obs, dtype=torch.int32) >= cfg.ba_min_obs)
    if not _read_flag(do_ba):
        zero = _scalar(0.0, torch.float32, dev)
        return state, _scalar(False, torch.bool, dev), zero, zero

    problem = BAProblem(
        poses_wc=kf.poses[win_slots],
        landmarks=lm.xyz,
        obs_pose=torch.clamp(wp, min=0),
        obs_lm=obs_lm,
        obs_uv=obs.uv,
        obs_mask=m_obs,
        obs_z=obs.z,
        obs_zw=torch.where(m_obs, obs.zw, torch.zeros((), device=dev)),
    )
    res = bundle_adjust(problem, camera.fx, camera.fy, camera.cx, camera.cy,
                        iterations=cfg.ba_iterations, damping=cfg.ba_damping, huber_px=cfg.ba_huber_px)
    opt = se3.orthonormalize_T(res.poses_wc)
    new_poses = _put_drop(kf.poses, torch.where(win_valid, win_slots, torch.full_like(win_slots, K)), opt)
    # The live pose rides the newest window keyframe's correction (on a
    # promotion frame that keyframe is the current pose).
    cur = state.current_kf
    pos_new = row(win_of_slot, cur)
    corr = torch.where(pos_new >= 0, row(opt, torch.clamp(pos_new, min=0)) @ se3.inverse(row(kf.poses, cur)),
                       torch.eye(4, device=dev))
    new_odom = state.odom._replace(
        pose=se3.orthonormalize_T(corr @ state.odom.pose),
        kf_pose=se3.orthonormalize_T(corr @ state.odom.kf_pose),
    )
    s2 = state._replace(keyframes=kf._replace(poses=new_poses), landmarks=lm._replace(xyz=res.landmarks),
                        odom=new_odom)
    return s2, _scalar(True, torch.bool, dev), res.initial_cost, res.final_cost


def correct_with_pose_graph(state: SlamState, iterations: int = 10) -> SlamState:
    """Run pose-graph GN over the keyframe poses and write them back; the
    live pose and the landmarks ride the corrections."""
    kf, edges, lm = state.keyframes, state.edges, state.landmarks
    graph = PoseGraph(poses_wc=kf.poses, edge_i=edges.i, edge_j=edges.j, edge_T=edges.T,
                      edge_weight=edges.weight, edge_mask=edges.mask)
    opt, _, _ = optimize_pose_graph(graph, iterations=iterations)
    # Invalid slots stay; the live pose shifts by the current keyframe's correction.
    cur = state.current_kf
    corr = row(opt, cur) @ se3.inverse(row(kf.poses, cur))
    new_poses = se3.orthonormalize_T(torch.where(kf.valid[:, None, None], opt, kf.poses))
    new_odom = state.odom._replace(
        pose=se3.orthonormalize_T(corr @ state.odom.pose),
        kf_pose=se3.orthonormalize_T(corr @ state.odom.kf_pose),
    )
    # Landmarks ride their anchor keyframe's correction.
    corr_all = opt @ se3.inverse(kf.poses)  # (K, 4, 4)
    lc = corr_all[torch.clamp(lm.anchor, 0, corr_all.shape[0] - 1).long()]
    lx = (lc[:, :3, :3] @ lm.xyz[:, :, None])[:, :, 0] + lc[:, :3, 3]
    new_lm = lm._replace(xyz=torch.where(lm.mask[:, None], lx, lm.xyz))
    return state._replace(keyframes=kf._replace(poses=new_poses), landmarks=new_lm, odom=new_odom)


def run_slam(camera: PinholeCamera, depths, grays, cfg: SlamConfig = SlamConfig()):
    """Host loop over (depth, gray) frames (arrays or tensors; the first
    depth's device is the run's, and one generator seeded 0 lives there).
    Returns (state, poses list, diags list).

    With ``cfg.correct_in_step`` (default) the pose-graph correction runs
    inside ``slam_step``; otherwise the closure flag of step t is read
    after step t+1 and the correction applied then."""
    depth0 = torch.as_tensor(depths[0])
    dev = depth0.device
    state = slam_init(camera, depth0, torch.as_tensor(grays[0], device=dev), cfg)
    poses = [torch.eye(4, device=dev)]
    diags = []
    generator = torch.Generator(device=dev).manual_seed(0)
    prev_flag = state.loop_found
    for d, g in zip(depths[1:], grays[1:]):
        state, diag = slam_step(state, torch.as_tensor(d, device=dev), torch.as_tensor(g, device=dev),
                                camera, generator, cfg)
        if not cfg.correct_in_step:
            if _read_flag(prev_flag):
                state = correct_with_pose_graph(state)
            prev_flag = state.loop_found
        poses.append(state.odom.pose)
        diags.append(diag)
    if not cfg.correct_in_step and _read_flag(prev_flag):
        state = correct_with_pose_graph(state)
        poses[-1] = state.odom.pose
    return state, poses, diags
