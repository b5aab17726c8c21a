"""Plain reference of keyframe-mode point-to-plane odometry, one step at a time.

Written from the algorithm the configuration states: backprojection
between ``min_depth`` and ``max_depth``, depth-image normals (central
differences, edge replication, oriented to the camera, valid where the
pixel and its four neighbours are and both tangents are under
``normal_max_edge``), a grid-stride subsample with the frame's phase
jitter (``frame_index * 97``) to ``point_budget`` source points and
``keyframe_budget`` keyframe points, ``icp_iterations`` damped,
Huber-weighted Gauss-Newton updates against the keyframe cloud from the
warm start ``inverse(kf_pose) @ pose`` (brute nearest neighbours, gated
at ``max_correspondence_distance``), the pose composed and brought back
onto SO(3) by Gram-Schmidt, and the promotion test on the step's twist
and overlap. A step starts from a state the caller gives it (the pose,
the keyframe's pose and cloud, the frame index).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.common import (SENTINEL, Precision, full_float32, gn_step, huber_weight,
                                        inverse, make_T, nearest, se3_log, transform)


class Features(NamedTuple):
    src: torch.Tensor       # (point_budget, 3), masked rows at the sentinel
    src_mask: torch.Tensor
    kf: torch.Tensor        # (keyframe_budget, 3), masked rows at the sentinel
    kf_normals: torch.Tensor
    kf_mask: torch.Tensor


class Step(NamedTuple):
    pose: np.ndarray        # (4, 4) world <- camera after the step
    promoted: bool
    margin: float           # relative distance of the promotion test from its nearest threshold
    features: Features


def features(depth: torch.Tensor, camera: dict, cfg: dict, phase: int) -> Features:
    h, w = depth.shape
    dev = depth.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    valid = torch.isfinite(depth) & (depth > cfg["min_depth"]) & (depth < cfg["max_depth"])
    z = torch.where(valid, depth, torch.zeros_like(depth))
    f = [torch.tensor(np.float32(camera[k]), device=dev) for k in ("fx", "fy", "cx", "cy")]
    p = torch.stack([(u - f[2]) / f[0] * z, (v - f[3]) / f[1] * z, z], -1)
    du = torch.cat([p[:, 1:2] - p[:, 0:1], (p[:, 2:] - p[:, :-2]) * 0.5, p[:, -1:] - p[:, -2:-1]], 1)
    dv = torch.cat([p[1:2] - p[0:1], (p[2:] - p[:-2]) * 0.5, p[-1:] - p[-2:-1]], 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    n = torch.where(((-p) * n).sum(-1, keepdim=True) < 0, -n, n)
    pad = torch.nn.functional.pad(valid[None, None].float(), (1, 1, 1, 1), mode="replicate")[0, 0] > 0.5
    neighbours = pad[1:-1, :-2] & pad[1:-1, 2:] & pad[:-2, 1:-1] & pad[2:, 1:-1]
    short = (torch.linalg.vector_norm(du, dim=-1) < cfg["normal_max_edge"]) & (
        torch.linalg.vector_norm(dv, dim=-1) < cfg["normal_max_edge"])
    good = (valid & neighbours & short & (norm[..., 0] > 1e-12)).reshape(-1)
    p, n = p.reshape(-1, 3), n.reshape(-1, 3)

    def pick(budget):
        stride = max((h * w) // budget, 1)
        return torch.clamp(torch.arange(budget, device=dev) * stride + phase % stride, 0, h * w - 1)

    si, ki = pick(cfg["point_budget"]), pick(cfg["keyframe_budget"])
    park = torch.full_like(p[:1], SENTINEL)
    return Features(torch.where(good[si, None], p[si], park), good[si],
                    torch.where(good[ki, None], p[ki], park), n[ki], good[ki])


def init(depth, camera, cfg) -> Features:
    """The first keyframe (phase 0)."""
    with full_float32():
        return features(depth, camera, cfg, 0)


def _orthonormalize(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    c0 = R[:, 0] / torch.clamp(torch.linalg.vector_norm(R[:, 0]), min=1e-12)
    c1 = R[:, 1] - (c0 * R[:, 1]).sum() * c0
    c1 = c1 / torch.clamp(torch.linalg.vector_norm(c1), min=1e-12)
    return make_T(torch.stack([c0, c1, torch.linalg.cross(c0, c1, dim=-1)], -1), T[:3, 3])


def step(pose, kf_pose, kf_points, kf_normals, kf_mask, frame_index: int, depth, camera, cfg,
         prec: Precision = Precision()) -> Step:
    """One odometry step from the given state; tensors on one device."""
    with full_float32():
        return _step(pose, kf_pose, kf_points, kf_normals, kf_mask, frame_index, depth, camera, cfg, prec)


def _step(pose, kf_pose, kf_points, kf_normals, kf_mask, frame_index, depth, camera, cfg, prec):
    feat = features(depth, camera, cfg, frame_index * 97)
    target = torch.where(kf_mask[:, None], kf_points, torch.full_like(kf_points, SENTINEL))
    max_d2 = cfg["max_correspondence_distance"] ** 2
    T = inverse(kf_pose) @ pose
    gate = ngate = None
    for _ in range(cfg["icp_iterations"]):
        st = transform(T, feat.src, prec)
        idx, d2 = nearest(st, target, prec)
        gate = feat.src_mask & (d2 <= max_d2)
        ngate = gate.sum()
        r = (kf_normals[idx] * (st - target[idx])).sum(-1)
        w = gate.to(torch.float32) * huber_weight(r, cfg["huber_delta"])
        T, _ = gn_step(T, st, target[idx], kf_normals[idx], w, cfg["damping"], prec)
    # The overlap of the last iteration's correspondences (at its start).
    overlap = float(ngate) / max(int(feat.src_mask.sum()), 1)
    new_pose = _orthonormalize(kf_pose @ T)
    delta = se3_log(T)
    tests = [(float(torch.linalg.vector_norm(delta[:3])), cfg["kf_translation"], 1.0),
             (float(torch.linalg.vector_norm(delta[3:])), cfg["kf_rotation"], 1.0),
             (overlap, cfg["kf_min_overlap"], -1.0)]
    promoted = any(s * (v - t) > 0 for v, t, s in tests)
    margin = min(abs(v - t) / t for v, t, _ in tests)
    return Step(new_pose.cpu().numpy(), promoted, margin, feat)
