"""Camera calibration: homographies, Zhang intrinsics, extrinsics, and the
joint refinement of a multi-camera rig.

Counterpart of ``perception_tpu/ops/calibration.py`` (the capability of the
reference's ``openpose/src/openpose/calibration/cameraParameterEstimation.cpp``):
per-view DLT homographies with Hartley normalisation, the IAC constraint
system -> closed-form K, per-view extrinsics from H and K, pairwise
camera-to-camera extrinsics by averaging per-view relative poses
(quaternion eigen-mean), and a Huber Gauss-Newton refinement of every
camera and board pose together. Chessboard detection is in-house
(``ops/chessboard.py``), with a cv2 backend where cv2 imports.

Every function is batched over views where the JAX package vmaps. On
CUDA each eigh reads the card once and each SVD (``se3.orthonormalize``)
twice; ``joint_extrinsics_refine`` reads nothing back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import jacfwd

from perception_tpu_torch._tensor import const
from perception_tpu_torch.geometry import se3


def _inv(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the host read of ``torch.linalg.inv``'s check."""
    return torch.linalg.inv_ex(M)[0]


def _normalizer(pts: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation (..., 3, 3) of (..., N, 2) points: centroid to
    the origin, mean distance sqrt(2)."""
    c = pts.mean(dim=-2)
    dist = torch.linalg.vector_norm(pts - c[..., None, :], dim=-1).mean(dim=-1)
    s = const(float(np.sqrt(np.float32(2.0))), pts) / torch.clamp(dist, min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * c[..., 0]], dim=-1),
        torch.stack([zero, s, -s * c[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def _hom(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def homography_dlt(obj_xy: torch.Tensor, img_uv: torch.Tensor) -> torch.Tensor:
    """Planar DLT homography H (..., 3, 3), img ~ H [X, Y, 1], with Hartley
    normalisation: (N, 2) board points, (..., N, 2) pixels of one or more
    views. The smallest eigenvector of the 9x9 ``A^T A``, as the JAX
    package takes it."""
    obj_xy = obj_xy.expand(img_uv.shape)
    To = _normalizer(obj_xy)
    Ti = _normalizer(img_uv)
    o = _hom(obj_xy) @ To.transpose(-1, -2)
    i = _hom(img_uv) @ Ti.transpose(-1, -2)
    zeros = torch.zeros_like(o)
    r1 = torch.cat([o, zeros, -i[..., 0:1] * o], dim=-1)
    r2 = torch.cat([zeros, o, -i[..., 1:2] * o], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    H = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    H = _inv(Ti) @ H @ To
    return H / H[..., 2:3, 2:3]


def _v_ij(H, i, j):
    return torch.stack(
        [
            H[..., 0, i] * H[..., 0, j],
            H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
            H[..., 1, i] * H[..., 1, j],
            H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
            H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
            H[..., 2, i] * H[..., 2, j],
        ],
        dim=-1,
    )


def intrinsics_zhang(homographies: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) homographies (>= 3 views) -> K (3, 3) from the IAC
    constraints (Zhang 2000, closed form). Every output is of degree 0 in
    the eigenvector b, so its sign does not matter."""
    Vm = torch.stack([_v_ij(homographies, 0, 1),
                      _v_ij(homographies, 0, 0) - _v_ij(homographies, 1, 1)], dim=-2).reshape(-1, 6)
    _, evecs = torch.linalg.eigh(Vm.T @ Vm)
    b11, b12, b22, b13, b23, b33 = evecs[:, 0]

    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = torch.sqrt(torch.abs(lam / b11))
    beta = torch.sqrt(torch.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    gamma = -b12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([
        torch.stack([alpha, gamma, u0]),
        torch.stack([zero, beta, v0]),
        torch.stack([zero, zero, one]),
    ])


def extrinsics_from_homography(K: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Board pose (camera <- board, (..., 4, 4)) from K (3, 3) and the
    views' H (..., 3, 3). The homography's scale sign is arbitrary: a
    board behind the camera (t_z < 0) is flipped (r1, r2, t negated)."""
    Kinv = _inv(K)
    h = Kinv @ H  # columns h1, h2, h3
    h1, h2, h3 = h[..., :, 0], h[..., :, 1], h[..., :, 2]
    lam = const(1.0, h) / torch.clamp(torch.linalg.vector_norm(h1, dim=-1), min=1e-12)
    flip = torch.sign(h3[..., 2] * lam)
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    r1 = h1 * lam[..., None] * flip[..., None]
    r2 = h2 * lam[..., None] * flip[..., None]
    t = h3 * lam[..., None] * flip[..., None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = se3.orthonormalize(torch.stack([r1, r2, r3], dim=-1))
    return se3.make_T(R, t)


def average_rotations(Rs: torch.Tensor) -> torch.Tensor:
    """Chordal L2 rotation average of (V, 3, 3) by the quaternion
    eigen-method."""
    qs = se3.matrix_to_quat(Rs)  # (V, 4)
    signs = torch.sign(torch.sum(qs * qs[0], dim=1, keepdim=True))  # hemisphere of the first
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    qs = qs * signs
    _, V = torch.linalg.eigh(qs.T @ qs)
    return se3.quat_to_matrix(V[:, -1])


def pairwise_extrinsics(T_cam0_board: torch.Tensor, T_cam1_board: torch.Tensor) -> torch.Tensor:
    """(V, 4, 4) board poses in two cameras -> averaged T_cam0_cam1."""
    rel = T_cam0_board @ se3.inverse(T_cam1_board)
    R = average_rotations(rel[:, :3, :3])
    t = rel[:, :3, 3].mean(dim=0)
    return se3.make_T(R, t)


def chessboard_object_points(rows: int, cols: int, square: float) -> np.ndarray:
    """(rows*cols, 2) planar board model (meters)."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([xs.ravel() * square, ys.ravel() * square], 1).astype(np.float32)


def detect_chessboard(gray: np.ndarray, rows: int, cols: int, backend: str = "native", device="cuda"):
    """Corner detection; returns (rows*cols, 2) row-major or None.

    ``backend='native'`` (default) runs the in-house saddle detector and
    lattice ordering (``ops/chessboard.py``) on ``device``;
    ``backend='cv2'`` delegates to OpenCV on the host, where cv2 imports."""
    if backend == "native":
        from perception_tpu_torch.ops.chessboard import detect_chessboard_native

        g = np.asarray(gray, np.float32)
        if g.max() > 1.5:  # uint8-scaled input
            g = g / np.float32(255.0)
        return detect_chessboard_native(g, rows, cols, device=device)
    if backend != "cv2":
        raise ValueError(f"unknown backend {backend!r}")
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("detect_chessboard(backend='cv2') needs OpenCV (cv2), which is not "
                           "installed; use backend='native'") from e

    found, corners = cv2.findChessboardCorners(
        gray.astype(np.uint8), (cols, rows),
        flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE,
    )
    if not found:
        return None
    corners = cv2.cornerSubPix(
        gray.astype(np.uint8), corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
    )
    return corners.reshape(-1, 2)


def calibrate_camera(object_xy: torch.Tensor, image_uvs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) board model + (V, N, 2) corner observations -> (K (3, 3),
    board poses (V, 4, 4)). Four host reads on CUDA: the homographies' and
    K's eigh, the extrinsics' SVD."""
    Hs = homography_dlt(object_xy, image_uvs)
    K = intrinsics_zhang(Hs)
    return K, extrinsics_from_homography(K, Hs)


def joint_extrinsics_refine(
    T_rig_cam: torch.Tensor,    # (C, 4, 4) rig <- camera initial extrinsics
    T_rig_board: torch.Tensor,  # (B, 4, 4) rig <- board initial poses
    Ks: torch.Tensor,           # (C, 3, 3) per-camera intrinsics
    obj_pts: torch.Tensor,      # (P, 3) board-frame corner points
    obs_uv: torch.Tensor,       # (C, B, P, 2) detected corners
    obs_mask: torch.Tensor,     # (C, B) board visible in camera
    iterations: int = 10,
    damping: float = 1e-4,
    huber_px: float = 2.0,
):
    """Refine every camera extrinsic and board pose of a rig together over
    all corner reprojections (the refinement stage of the reference's
    ``cameraParameterEstimation.cpp``, after the pairwise initialisation).

    Gauss-Newton over se(3) twists with camera 0 fixed (the gauge); the
    Jacobian of the stacked (C + B) x 6 update by ``torch.func.jacfwd``;
    Huber IRLS weights from the residuals, held constant in the step; a
    step is kept only where it lowers the rms (``torch.where``, no host
    read). Returns (T_rig_cam', T_rig_board', initial_rms_px, final_rms_px)."""
    C = T_rig_cam.shape[0]
    B = T_rig_board.shape[0]
    mask_f = obs_mask.to(obs_uv.dtype)[:, :, None, None]
    fx, fy = Ks[:, None, None, 0, 0], Ks[:, None, None, 1, 1]
    cx, cy = Ks[:, None, None, 0, 2], Ks[:, None, None, 1, 2]

    def residuals(T_cams, T_boards):
        # A corner in camera c: T_cam^-1 T_board X.
        T_cb = torch.einsum("cij,bjk->cbik", se3.inverse(T_cams), T_boards)
        pc = torch.einsum("cbij,pj->cbpi", T_cb[..., :3, :3], obj_pts) + T_cb[:, :, None, :3, 3]
        z = torch.clamp(pc[..., 2], min=1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        return (torch.stack([u, v], dim=-1) - obs_uv) * mask_f  # (C, B, P, 2)

    def apply(delta, T_cams, T_boards):
        dc = delta[: C * 6].reshape(C, 6)
        dc = torch.cat([torch.zeros_like(dc[:1]), dc[1:]])  # gauge: camera 0 fixed
        db = delta[C * 6:].reshape(B, 6)
        return se3.se3_exp(dc) @ T_cams, se3.se3_exp(db) @ T_boards

    n_obs = torch.clamp(torch.sum(mask_f) * obj_pts.shape[0] * 2, min=1.0)

    def rms(T_cams, T_boards):
        r = residuals(T_cams, T_boards)
        return torch.sqrt(torch.sum(r * r) / n_obs)

    nparam = (C + B) * 6
    eye = damping * torch.eye(nparam, dtype=obs_uv.dtype, device=obs_uv.device)
    gauge = torch.arange(nparam, device=obs_uv.device) < 6
    gauge_diag = torch.diag(gauge.to(obs_uv.dtype))
    free = ~(gauge[:, None] | gauge[None, :])
    d0 = torch.zeros(nparam, dtype=obs_uv.dtype, device=obs_uv.device)
    huber = const(huber_px, obs_uv)
    Tc, Tb = T_rig_cam, T_rig_board
    rms0 = rms(Tc, Tb)
    for _ in range(iterations):
        def r_of(delta, Tc=Tc, Tb=Tb):
            return residuals(*apply(delta, Tc, Tb)).reshape(-1)

        r = r_of(d0)
        J = jacfwd(r_of)(d0)  # (N, (C+B)*6)
        # Huber IRLS on per-corner residual norms, outside the Jacobian.
        rn = torch.sqrt(r[0::2] ** 2 + r[1::2] ** 2)
        w = torch.where(rn <= huber_px, torch.ones_like(rn), huber / torch.clamp(rn, min=1e-9))
        Jw = J * torch.stack([w, w], dim=-1).reshape(-1, 1)  # one weight for u and v
        A = Jw.T @ J + eye
        A = torch.where(free, A, gauge_diag)  # camera 0's rows and columns: identity
        b = torch.where(gauge, torch.zeros_like(d0), -(Jw.T @ r))
        delta = torch.linalg.solve_ex(A, b)[0]
        tc, tb = apply(delta, Tc, Tb)
        better = rms(tc, tb) < rms(Tc, Tb)
        Tc = torch.where(better, tc, Tc)
        Tb = torch.where(better, tb, Tb)
    Tc = se3.orthonormalize_T(Tc)
    Tb = se3.orthonormalize_T(Tb)
    return Tc, Tb, rms0, rms(Tc, Tb)
