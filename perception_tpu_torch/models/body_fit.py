"""Articulated total-body model fitting (joint-angle estimation).

Counterpart of ``perception_tpu/models/body_fit.py``, the capability of the
reference's ``Adam_FastFit`` step
(``openpose/src/openpose/3d/jointAngleEstimation.cpp:313-360``, with the
OpenPose -> Adam joint mapping at ``:114``):

  * a kinematic tree of per-joint axis-angle rotations and bone lengths
    over a BODY_25-shaped skeleton, posed by forward kinematics (a loop
    over the topologically sorted joints that stacks lists, so
    ``torch.func`` can differentiate through it);
  * a Levenberg-Marquardt fit of (global SE(3) twist, joint angles, log
    bone scale) to observed 3-D keypoints with Huber weights and an angle
    prior; its Jacobian is ``torch.func.jacfwd`` of the whole residual,
    through the Huber weights, as ``jax.jacfwd`` is in the JAX package;
  * batched over people by ``torch.func.vmap``.

Conventions: angles are per-joint axis-angle (3,) in the parent frame;
joint j's frame = parent's frame . Rot(angles[j]), offset by
``bone_dirs[j] * bone_lengths[j] * scale`` in the parent frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from perception_tpu_torch._tensor import const, norm_rn, sqrt_rn
from perception_tpu_torch.geometry import se3

# --- default skeleton (BODY_25-compatible subset, 15 joints) ---------------
# Topologically ordered: parent index < joint index; joint 0 is the root
# (MidHip in BODY_25 numbering).

BODY15_NAMES = [
    "MidHip", "Neck", "Nose",           # 0 1 2   spine chain
    "RHip", "RKnee", "RAnkle",          # 3 4 5
    "LHip", "LKnee", "LAnkle",          # 6 7 8
    "RShoulder", "RElbow", "RWrist",    # 9 10 11
    "LShoulder", "LElbow", "LWrist",    # 12 13 14
]

BODY15_PARENTS = np.array([-1, 0, 1, 0, 3, 4, 0, 6, 7, 1, 9, 10, 1, 12, 13], np.int32)

# Rest-pose bone directions (unit, in the parent joint frame) and lengths
# (meters) of an average adult; lengths get a fitted global scale.
BODY15_BONE_DIRS = np.array(
    [
        [0, 0, 0],        # root (unused)
        [0, -1, 0],       # MidHip -> Neck
        [0, -1, 0],       # Neck -> Nose
        [-1, 0, 0],       # MidHip -> RHip
        [0, 1, 0],        # RHip -> RKnee
        [0, 1, 0],        # RKnee -> RAnkle
        [1, 0, 0],        # MidHip -> LHip
        [0, 1, 0],        # LHip -> LKnee
        [0, 1, 0],        # LKnee -> LAnkle
        [-1, 0, 0],       # Neck -> RShoulder
        [0, 1, 0],        # RShoulder -> RElbow
        [0, 1, 0],        # RElbow -> RWrist
        [1, 0, 0],        # Neck -> LShoulder
        [0, 1, 0],        # LShoulder -> LElbow
        [0, 1, 0],        # LElbow -> LWrist
    ],
    np.float32,
)

BODY15_BONE_LENGTHS = np.array(
    [0.0, 0.50, 0.18, 0.11, 0.42, 0.42, 0.11, 0.42, 0.42,
     0.17, 0.30, 0.26, 0.17, 0.30, 0.26],
    np.float32,
)

# BODY_25 keypoint index observed for each skeleton joint.
BODY15_TO_BODY25 = np.array([8, 1, 0, 9, 10, 11, 12, 13, 14, 2, 3, 4, 5, 6, 7], np.int32)


class BodyModel(NamedTuple):
    """Static skeleton description (host constants)."""

    parents: np.ndarray       # (J,) int32, parents[0] == -1
    bone_dirs: np.ndarray     # (J, 3) unit directions in parent frame
    bone_lengths: np.ndarray  # (J,) meters

    @classmethod
    def body15(cls) -> "BodyModel":
        return cls(BODY15_PARENTS, BODY15_BONE_DIRS, BODY15_BONE_LENGTHS)


class BodyFitResult(NamedTuple):
    root_T: torch.Tensor     # (..., 4, 4) world-from-root
    angles: torch.Tensor     # (..., J, 3) axis-angle per joint
    scale: torch.Tensor      # (...) global bone-length scale
    joints: torch.Tensor     # (..., J, 3) posed joint positions (world)
    residual: torch.Tensor   # (...) final mean joint error (m)
    accepted: torch.Tensor   # (..., iterations) bool: the LM steps taken


def forward_kinematics(
    model: BodyModel,
    root_T: torch.Tensor,  # (4, 4)
    angles: torch.Tensor,  # (J, 3)
    scale=1.0,             # () tensor or number
) -> torch.Tensor:
    """Pose the skeleton: world positions (J, 3) of every joint."""
    J = model.parents.shape[0]
    dirs = const(model.bone_dirs.tolist(), angles)
    lens = const(model.bone_lengths.tolist(), angles) * scale
    Rs = se3.so3_exp(angles)  # (J, 3, 3) local joint rotations
    R_acc = [root_T[:3, :3] @ Rs[0]]
    t_acc = [root_T[:3, 3]]
    for j in range(1, J):
        p = int(model.parents[j])
        t_acc.append(t_acc[p] + R_acc[p] @ (dirs[j] * lens[j]))
        R_acc.append(R_acc[p] @ Rs[j])
    return torch.stack(t_acc)


def _unpack(theta, J):
    return theta[:6], theta[6:6 + 3 * J].reshape(J, 3), theta[6 + 3 * J]


def _root_T(twist: torch.Tensor) -> torch.Tensor:
    """``se3_exp`` of one twist through a batch of one: under
    ``torch.func.jacfwd`` a 0-dim tensor combined with a Python float
    gives a float64 tangent, and se3_exp's angle is 0-dim for one twist."""
    return se3.se3_exp(twist[None])[0]


def fit_body(
    observed: torch.Tensor,  # (..., J, 3) world keypoint positions
    obs_mask: torch.Tensor,  # (..., J) bool
    model: Optional[BodyModel] = None,
    iterations: int = 30,
    huber_delta: float = 0.10,
    angle_weight: float = 1e-3,
    damping: float = 1e-3,
    fit_scale: bool = True,
) -> BodyFitResult:
    """LM fit of root pose + joint angles (+ log bone scale) to observed
    3-D joints, one person (J, 3) or a batch (..., J, 3).

    ``observed`` rows are ordered like the model's joints; map BODY_25
    keypoints through :data:`BODY15_TO_BODY25` first (see
    :func:`fit_body_from_body25`). Missing joints are masked. A step is
    accepted or rejected through ``torch.where``, with no host read."""
    model = model or BodyModel.body15()
    J = model.parents.shape[0]
    batch = observed.shape[:-2]
    obs = observed.reshape(-1, J, 3)
    w_mask = obs_mask.reshape(-1, J).to(obs.dtype)
    dtype, dev = obs.dtype, obs.device
    delta_h = const(huber_delta, obs)

    def scale_of(log_s):
        return torch.exp(log_s) if fit_scale else torch.ones_like(log_s)

    def residuals(theta, observed1, w1):
        twist, angles, log_s = _unpack(theta, J)
        joints = forward_kinematics(model, _root_T(twist), angles, scale_of(log_s))
        r = (joints - observed1) * w1[:, None]
        # Huber weights on the 3-D error norm, inside the differentiated
        # function: a masked joint (r = 0) stays in the 1.0 branch.
        n = norm_rn(r)
        w = torch.where(n > huber_delta, sqrt_rn(delta_h / torch.clamp(n, min=1e-9)), torch.ones_like(n))
        r = (r * w[:, None]).reshape(-1)
        # Angle prior keeps unobserved chains at rest.
        return torch.cat([r, angle_weight * angles.reshape(-1)])

    res_b = vmap(residuals)
    jac_b = vmap(jacfwd(residuals))

    # Initialization: root at the observed root joint, identity pose.
    root0 = torch.where(w_mask[:, :1] > 0, obs[:, 0], torch.zeros_like(obs[:, 0]))
    theta = torch.cat([root0, torch.zeros((obs.shape[0], 3 + 3 * J + 1), dtype=dtype, device=dev)], dim=1)
    lam = torch.full((obs.shape[0],), damping, dtype=dtype, device=dev)
    accepted = []
    for _ in range(iterations):
        r = res_b(theta, obs, w_mask)
        Jac = jac_b(theta, obs, w_mask)
        H = Jac.transpose(-1, -2) @ Jac
        g = (r[..., None, :] @ Jac)[..., 0, :]  # J^T r; a matrix-vector product rounds by batch size
        H = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)
        delta = torch.linalg.solve_ex(H, -g)[0]
        theta_new = theta + delta
        better = torch.sum(res_b(theta_new, obs, w_mask) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        theta = torch.where(better[:, None], theta_new, theta)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 4.0, max=1e3))
        accepted.append(better)

    def pose(theta1):
        twist, angles, log_s = _unpack(theta1, J)
        scale = scale_of(log_s)
        T = _root_T(twist)
        return T, angles, scale, forward_kinematics(model, T, angles, scale)

    T, angles, scale, joints = vmap(pose)(theta)
    err = norm_rn(joints - obs)
    denom = torch.clamp(torch.sum(w_mask, dim=-1), min=1.0)
    residual = torch.sum(err * w_mask, dim=-1) / denom
    out = (T, angles, scale, joints, residual, torch.stack(accepted, dim=-1))
    return BodyFitResult(*(t.reshape(batch + t.shape[1:]) for t in out))


def fit_body_from_body25(
    keypoints3d: torch.Tensor,  # (..., 25, 3) triangulated BODY_25 keypoints
    confidence: torch.Tensor,   # (..., 25)
    conf_threshold: float = 0.05,
    **kwargs,
) -> BodyFitResult:
    """Gather the BODY_25 keypoints the skeleton observes (the OP -> model
    joint mapping, jointAngleEstimation.cpp:114) and fit; one person
    (25, 3) or people (P, 25, 3)."""
    sel = torch.from_numpy(BODY15_TO_BODY25.astype(np.int64)).to(keypoints3d.device, non_blocking=True)
    obs = keypoints3d.index_select(-2, sel)
    mask = confidence.index_select(-1, sel) > conf_threshold
    return fit_body(obs, mask, **kwargs)
