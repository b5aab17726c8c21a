"""Synthetic face scenes for the face fixture.

Counterpart of the scene half of ``perception_tpu/models/face_data.py``,
in numpy: a rigid 70-point canonical 3-D face whose anchor landmarks are
``models/face.PNP_MODEL_POINTS``, an AU02 (brow raiser) deformation,
random head poses drawn from a ``numpy.random.Generator`` and projected
through a pinhole camera, and the analytic grayscale renderer (bright
skin, dark brows, eye rings, pupils, nose and mouth) that both detectors
fire on. ``render_face`` on the same scene arrays gives the JAX
package's image to float32 rounding. The training targets
(``landmark_heatmap_targets``, ``detector_targets``, ``make_face_batch``)
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.face import NUM_FACE_LANDMARKS

_F32 = np.float32


def _build_canonical() -> np.ndarray:
    """70 landmarks (m), head frame: x right, y down, z forward. The
    anchors are face.PNP_MODEL_POINTS."""
    L = np.zeros((NUM_FACE_LANDMARKS, 3), np.float32)

    # Jaw 0-16: ears high (y ~ -0.01), chin low (y = 0.066).
    s = np.linspace(-1.0, 1.0, 17)
    L[0:17, 0] = 0.075 * s
    L[0:17, 1] = 0.066 - 0.076 * (np.abs(s) ** 1.5)
    L[0:17, 2] = -0.013 - 0.047 * s * s
    L[8] = (0.0, 0.066, -0.013)  # chin anchor exactly

    # Brows 17-21 (right, x<0), 22-26 (left).
    bx = np.linspace(-0.055, -0.013, 5)
    L[17:22, 0] = bx
    L[17:22, 1] = -0.048 - 0.004 * np.sin(np.linspace(0, np.pi, 5))
    L[17:22, 2] = -0.022
    L[22:27, 0] = -bx[::-1]
    L[22:27, 1] = L[17:22, 1][::-1]
    L[22:27, 2] = -0.022

    # Nose bridge 27-30 + nostril base 31-35.
    L[27:31, 0] = 0.0
    L[27:31, 1] = np.linspace(-0.033, 0.0, 4)
    L[27:31, 2] = np.linspace(-0.018, 0.0, 4)
    L[30] = (0.0, 0.0, 0.0)  # nose tip anchor
    L[31:36, 0] = np.linspace(-0.018, 0.018, 5)
    L[31:36, 1] = 0.012
    L[31:36, 2] = -0.008

    # Eyes: hexagon rings. Right 36-41 (x<0), left 42-47.
    def eye_ring(cx_, outer_first):
        ex = np.array([-0.0135, -0.0075, 0.0025, 0.0135, 0.0045, -0.0055])
        ey = np.array([0.0, -0.005, -0.0055, 0.0, 0.005, 0.0055])
        ring = np.stack([cx_ + ex, -0.034 + ey, np.full(6, -0.026)], axis=1)
        if not outer_first:  # mirrored: inner corner first for the left eye
            ring[:, 0] = 2 * cx_ - ring[:, 0]
        return ring

    L[36:42] = eye_ring(-0.0315, True)
    L[36] = (-0.045, -0.034, -0.027)  # right outer anchor
    L[39] = (-0.018, -0.034, -0.026)  # right inner
    L[42:48] = eye_ring(0.0315, False)
    L[42] = (0.018, -0.034, -0.026)   # left inner
    L[45] = (0.045, -0.034, -0.027)   # left outer anchor

    # Mouth: outer ellipse 48-59 (corner first), inner 60-67.
    a_out = np.linspace(np.pi, -np.pi, 12, endpoint=False)
    L[48:60, 0] = 0.029 * np.cos(a_out)
    L[48:60, 1] = 0.033 + 0.011 * -np.sin(a_out)
    L[48:60, 2] = -0.024 + 0.002 * np.cos(a_out)
    L[48] = (-0.029, 0.033, -0.024)  # right corner anchor
    L[54] = (0.029, 0.033, -0.024)   # left corner anchor
    a_in = np.linspace(np.pi, -np.pi, 8, endpoint=False)
    L[60:68, 0] = 0.020 * np.cos(a_in)
    L[60:68, 1] = 0.033 + 0.005 * -np.sin(a_in)
    L[60:68, 2] = -0.023

    # Pupils 68 (right), 69 (left).
    L[68] = (-0.0315, -0.034, -0.024)
    L[69] = (0.0315, -0.034, -0.024)
    return L


CANONICAL_FACE_3D = _build_canonical()
BROW_IDS = np.arange(17, 27)

# Polyline segment groups for rendering (consecutive-index chains).
_CHAINS = [
    list(range(0, 17)),            # jaw
    list(range(17, 22)),           # right brow
    list(range(22, 27)),           # left brow
    list(range(27, 31)),           # nose bridge
    list(range(31, 36)),           # nostril base
    list(range(36, 42)) + [36],    # right eye ring (closed)
    list(range(42, 48)) + [42],    # left eye ring (closed)
    list(range(48, 60)) + [48],    # outer mouth (closed)
]


class FaceScene(NamedTuple):
    pose: np.ndarray         # (..., 4, 4) camera <- head
    landmarks2d: np.ndarray  # (..., 70, 2) projected pixels
    landmarks3d: np.ndarray  # (..., 70, 3) camera-frame points
    au02: np.ndarray         # (...) brow raise in [0, 1]


def deformed_model(au02) -> np.ndarray:
    """The canonical model with the AU02 brow raise: brows move up (-y,
    head frame) by up to 9 mm."""
    lift = np.zeros((NUM_FACE_LANDMARKS, 3), np.float32)
    lift[BROW_IDS, 1] = -0.009
    return CANONICAL_FACE_3D + _F32(au02) * lift


def _rotation(omega) -> np.ndarray:
    """Axis-angle (3,) -> (3, 3) float32 rotation by ``geometry/se3.so3_exp``."""
    return se3.so3_exp(torch.from_numpy(np.asarray(omega, np.float32))).numpy()


_R_FACE_CAMERA = _rotation([0.0, np.pi, 0.0])


def scene_from_pose(rot, txy, z, au02, hw: Tuple[int, int], fx: float, fy: float) -> FaceScene:
    """The scene of a head at rotation ``rot`` (axis-angle wobble on top of
    the y-flip that makes the subject face the camera), position (txy, z)
    in metres and brow raise ``au02``, projected into an (H, W) image."""
    H, W = hw
    R = _rotation(rot) @ _R_FACE_CAMERA
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = (txy[0], txy[1], z)
    pc = deformed_model(au02) @ R.T + T[:3, 3]
    zc = np.maximum(pc[:, 2], _F32(1e-6))
    uv = np.stack([_F32(fx) * pc[:, 0] / zc + _F32(W / 2.0), _F32(fy) * pc[:, 1] / zc + _F32(H / 2.0)], axis=-1)
    return FaceScene(pose=T, landmarks2d=uv.astype(np.float32), landmarks3d=pc.astype(np.float32),
                     au02=np.float32(au02))


def _sample_au02(rng: np.random.Generator) -> float:
    """Raised (0.6-1.0) or neutral (0-0.15) brows, each half the time."""
    return rng.uniform(0.6, 1.0) if rng.random() < 0.5 else rng.uniform(0.0, 0.15)


def sample_face(rng: np.random.Generator, hw: Tuple[int, int], fx: float, fy: float, rot_range: float = 0.30,
                z_range: Tuple[float, float] = (0.45, 0.75)) -> FaceScene:
    """A random head pose and AU02 state, the face kept inside the frame
    (the model spans about +-0.085 m)."""
    H, W = hw
    rot = rng.uniform(-rot_range, rot_range, 3)
    z = rng.uniform(z_range[0], z_range[1])
    margin = 0.085
    lim = np.array([max((W / 2.0 - 8.0) / fx * z - margin, 0.0), max((H / 2.0 - 8.0) / fy * z - margin, 0.0)])
    txy = rng.uniform(-1.0, 1.0, 2) * lim
    return scene_from_pose(rot, txy, z, _sample_au02(rng), hw, fx, fy)


def sample_face_at(rng: np.random.Generator, hw: Tuple[int, int], fx: float, fy: float,
                   txy: Tuple[float, float], z: float, rot_range: float = 0.15, au02=None) -> FaceScene:
    """A face at an explicit position (metres, camera frame): the
    controlled placement of disjoint multi-face scenes."""
    rot = rng.uniform(-rot_range, rot_range, 3)
    if au02 is None:
        au02 = _sample_au02(rng)
    return scene_from_pose(rot, txy, z, au02, hw, fx, fy)


def stack_scenes(scenes) -> FaceScene:
    """Scenes stacked on a leading face axis."""
    return FaceScene(*(np.stack([getattr(s, f) for s in scenes]) for f in FaceScene._fields))


def _seg_dist(px, a, b):
    ab = b - a
    denom = np.maximum(np.dot(ab, ab), _F32(1e-8))
    t = np.clip(((px - a) * ab).sum(-1) / denom, _F32(0.0), _F32(1.0))
    proj = a + t[..., None] * ab
    return np.linalg.norm(px - proj, axis=-1)


def _face_layers(lm: np.ndarray, px: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One face's (skin, dark) fields in [0, 1] over the pixel grid."""
    lm = np.asarray(lm, np.float32)
    eye_span = np.linalg.norm(lm[45] - lm[36])
    stroke = np.clip(eye_span * _F32(0.05), _F32(0.8), _F32(4.0))

    # Skin: a soft ellipse over the landmarks' extent.
    c = lm.mean(axis=0)
    spread = np.sqrt(np.mean(np.sum((lm - c) ** 2, axis=-1)))
    d_face = np.linalg.norm(px - c, axis=-1)
    skin = np.clip(_F32(1.0) - (d_face - _F32(1.55) * spread) / (_F32(0.35) * spread), _F32(0.0), _F32(1.0))

    # Dark feature strokes along the chains.
    dmin = np.full(px.shape[:-1], 1e9, np.float32)
    for chain in _CHAINS:
        for i in range(len(chain) - 1):
            dmin = np.minimum(dmin, _seg_dist(px, lm[chain[i]], lm[chain[i + 1]]))
    line = np.clip(_F32(1.0) - (dmin - stroke) / _F32(1.2), _F32(0.0), _F32(1.0))

    # Eye sockets + pupils: filled dark discs.
    r_eye = np.clip(eye_span * _F32(0.085), _F32(1.5), _F32(8.0))
    d_eye = np.minimum(np.linalg.norm(px - lm[68], axis=-1), np.linalg.norm(px - lm[69], axis=-1))
    sockets = np.clip(_F32(1.0) - (d_eye - r_eye) / _F32(1.5), _F32(0.0), _F32(1.0))
    return skin, np.maximum(line * _F32(0.85), sockets)


def _compose(skin, dark, hw, rng: Optional[np.random.Generator], noise: Optional[np.ndarray]):
    img = (_F32(40.0) + _F32(160.0) * skin) * (_F32(1.0) - _F32(0.8) * dark)  # bg 40, skin up to 200
    if noise is None and rng is not None:
        noise = rng.standard_normal(hw).astype(np.float32)
    if noise is not None:
        img = img + np.asarray(noise, np.float32) * _F32(2.0)
    return np.clip(img, _F32(0.0), _F32(255.0))


def _pixel_grid(hw):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    return np.stack([xx, yy], -1).astype(np.float32)


def render_face(scene: FaceScene, hw: Tuple[int, int], rng: Optional[np.random.Generator] = None,
                noise: Optional[np.ndarray] = None) -> np.ndarray:
    """Grayscale (H, W) float32 in [0, 255]: bright skin, dark features.
    Noise of standard deviation 2: ``noise`` (H, W) standard normal
    values, else drawn from ``rng``, else none."""
    skin, dark = _face_layers(scene.landmarks2d, _pixel_grid(hw))
    return _compose(skin, dark, hw, rng, noise)


def render_faces(scenes: FaceScene, hw: Tuple[int, int], rng: Optional[np.random.Generator] = None,
                 noise: Optional[np.ndarray] = None) -> np.ndarray:
    """Several faces (``scenes`` stacked on a leading axis): the per-pixel
    maximum of their layers, exact for disjoint faces."""
    px = _pixel_grid(hw)
    layers = [_face_layers(lm, px) for lm in scenes.landmarks2d]
    skin = np.max([s for s, _ in layers], axis=0)
    dark = np.max([d for _, d in layers], axis=0)
    return _compose(skin, dark, hw, rng, noise)


def crop_box_from_landmarks(uv: np.ndarray, margin: float = 1.35) -> np.ndarray:
    """Square crop box (x1, y1, x2, y2) around (..., 70, 2) landmarks."""
    uv = np.asarray(uv, np.float32)
    lo, hi = uv.min(axis=-2), uv.max(axis=-2)
    c = _F32(0.5) * (lo + hi)
    half = _F32(0.5) * (hi - lo).max(axis=-1, keepdims=True) * _F32(margin)
    return np.concatenate([c - half, c + half], axis=-1)
