"""Synthetic face scenes for the face fixture.

Counterpart of ``perception_tpu/models/face_data.py``: a rigid 70-point
canonical 3-D face whose anchor landmarks are
``models/face.PNP_MODEL_POINTS``, an AU02 (brow raiser) deformation,
random head poses drawn from a ``numpy.random.Generator`` and projected
through a pinhole camera (numpy), and the analytic grayscale renderer
(bright skin, dark brows, eye rings, pupils, nose and mouth) that both
detectors fire on, in torch: ``render_faces_batch`` renders a batch on
the caller's device, ``render_face`` and ``render_faces`` one image on
the CPU, in numpy in and out. On the same scene arrays they give the JAX
package's image to float32 rounding.

The training half, in torch on the caller's device:
``landmark_heatmap_targets``, ``detector_targets`` and
``make_face_batch``. Its draws come from a ``numpy.random.Generator``
(``draw_face_batch``) or are given (``draws=``), so a batch can be made
from the JAX package's draws: ``draw_face_batch_from_key`` and
``sample_face_from_key`` replay them from a JAX key in numpy
(``utils.jax_random``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models._render import (
    crop_heatmaps,
    gaussian_maps,
    jittered_boxes,
    pixel_grid,
    point_distance,
    segment_distance,
)
from perception_tpu_torch.models.face import NUM_FACE_LANDMARKS
from perception_tpu_torch.utils import jax_random

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


def sample_face_from_key(key: np.ndarray, hw: Tuple[int, int], fx: float, fy: float, rot_range: float = 0.30,
                         z_range: Tuple[float, float] = (0.45, 0.75)) -> FaceScene:
    """``sample_face`` with the JAX package's draws: its ``sample_face(key,
    ...)`` for a JAX key (``utils.jax_random``), in float32 as JAX takes
    them."""
    H, W = hw
    k1, k2, k3, k4 = jax_random.split(key, 4)
    rot = jax_random.uniform(k1, (3,), -rot_range, rot_range)
    z = jax_random.uniform(k2, (), z_range[0], z_range[1])
    lim = np.maximum(np.array([(W / 2.0 - 8.0) / fx, (H / 2.0 - 8.0) / fy], _F32) * z - _F32(0.085), _F32(0.0))
    txy = jax_random.uniform(k3, (2,), -1.0, 1.0) * lim
    if jax_random.bernoulli(k4, 0.5):
        au02 = jax_random.uniform(jax_random.fold_in(k4, 1), (), 0.6, 1.0)
    else:
        au02 = jax_random.uniform(jax_random.fold_in(k4, 2), (), 0.0, 0.15)
    return scene_from_pose(rot, txy, z, au02, hw, fx, fy)


def sample_face_at(rng: np.random.Generator, hw: Tuple[int, int], fx: float, fy: float,
                   txy: Tuple[float, float], z: float, rot_range: float = 0.15, au02=None) -> FaceScene:
    """A face at an explicit position (metres, camera frame): the
    controlled placement of disjoint multi-face scenes."""
    rot = rng.uniform(-rot_range, rot_range, 3)
    if au02 is None:
        au02 = _sample_au02(rng)
    return scene_from_pose(rot, txy, z, au02, hw, fx, fy)


def sample_face_at_from_key(key: np.ndarray, hw: Tuple[int, int], fx: float, fy: float,
                            txy: Tuple[float, float], z: float, rot_range: float = 0.15) -> FaceScene:
    """``sample_face_at`` with the JAX package's draws: its
    ``sample_face_at(key, ...)`` for a JAX key (``utils.jax_random``)."""
    k1, k4 = jax_random.split(key)
    rot = jax_random.uniform(k1, (3,), -rot_range, rot_range)
    if jax_random.bernoulli(k4, 0.5):
        au02 = jax_random.uniform(jax_random.fold_in(k4, 1), (), 0.6, 1.0)
    else:
        au02 = jax_random.uniform(jax_random.fold_in(k4, 2), (), 0.0, 0.15)
    return scene_from_pose(rot, np.asarray(txy, _F32), _F32(z), au02, hw, fx, fy)


def stack_scenes(scenes) -> FaceScene:
    """Scenes stacked on a leading face axis."""
    return FaceScene(*(np.stack([getattr(s, f) for s in scenes]) for f in FaceScene._fields))


def crop_box_from_landmarks(uv: np.ndarray, margin: float = 1.35) -> np.ndarray:
    """Square crop box (x1, y1, x2, y2) around (..., 70, 2) landmarks."""
    uv = np.asarray(uv, np.float32)
    lo, hi = uv.min(axis=-2), uv.max(axis=-2)
    c = _F32(0.5) * (lo + hi)
    half = _F32(0.5) * (hi - lo).max(axis=-1, keepdims=True) * _F32(margin)
    return np.concatenate([c - half, c + half], axis=-1)


# --- renders and training batches (torch, on the caller's device) ---------

def _face_layers(lm: torch.Tensor, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (skin, dark) fields in [0, 1], each (..., H, W), of faces with
    landmarks (..., 70, 2)."""
    eye_span = torch.linalg.vector_norm(lm[..., 45, :] - lm[..., 36, :], dim=-1)[..., None, None]
    stroke = torch.clamp(eye_span * 0.05, 0.8, 4.0)

    # Skin: a soft ellipse over the landmarks' extent.
    c = lm.mean(-2)
    spread = torch.sqrt(((lm - c[..., None, :]) ** 2).sum(-1).mean(-1))[..., None, None]
    skin = torch.clamp(1.0 - (point_distance(X, Y, c) - 1.55 * spread) / (0.35 * spread), 0.0, 1.0)

    # Dark feature strokes along the chains.
    dmin = None
    for chain in _CHAINS:
        for i in range(len(chain) - 1):
            d = segment_distance(X, Y, lm[..., chain[i], :], lm[..., chain[i + 1], :])
            dmin = d if dmin is None else torch.minimum(dmin, d)
    line = torch.clamp(1.0 - (dmin - stroke) / 1.2, 0.0, 1.0)

    # Eye sockets + pupils: filled dark discs.
    r_eye = torch.clamp(eye_span * 0.085, 1.5, 8.0)
    d_eye = torch.minimum(point_distance(X, Y, lm[..., 68, :]), point_distance(X, Y, lm[..., 69, :]))
    sockets = torch.clamp(1.0 - (d_eye - r_eye) / 1.5, 0.0, 1.0)
    return skin, torch.maximum(line * 0.85, sockets)


def _compose(skin: torch.Tensor, dark: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    img = (40.0 + 160.0 * skin) * (1.0 - 0.8 * dark)  # bg 40, skin up to 200
    if noise is not None:
        img = img + noise * 2.0
    return torch.clamp(img, 0.0, 255.0)


def render_faces_batch(landmarks2d: torch.Tensor, hw: Tuple[int, int],
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grayscale renders of a batch, one face each, on the landmarks'
    device: bright skin, dark features, plus Gaussian noise of standard
    deviation 2. (B, 70, 2) -> (B, H, W) in [0, 255]; ``noise`` (B, H, W)
    standard normal or None."""
    X, Y = pixel_grid(hw, landmarks2d.device)
    return _compose(*_face_layers(landmarks2d, X, Y), noise)


def _cpu_noise(hw, rng: Optional[np.random.Generator], noise: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    if noise is None and rng is not None:
        noise = rng.standard_normal(hw).astype(np.float32)
    return None if noise is None else torch.from_numpy(np.asarray(noise, np.float32))


def render_face(scene: FaceScene, hw: Tuple[int, int], rng: Optional[np.random.Generator] = None,
                noise: Optional[np.ndarray] = None) -> np.ndarray:
    """``render_faces_batch`` of one scene on the CPU: (H, W) float32 in
    [0, 255]. The noise is ``noise`` (H, W) standard normal values, else
    drawn from ``rng``, else none."""
    lm = torch.from_numpy(np.asarray(scene.landmarks2d, np.float32))
    n = _cpu_noise(hw, rng, noise)
    return render_faces_batch(lm[None], hw, None if n is None else n[None])[0].numpy()


def render_faces(scenes: FaceScene, hw: Tuple[int, int], rng: Optional[np.random.Generator] = None,
                 noise: Optional[np.ndarray] = None) -> np.ndarray:
    """Several faces (``scenes`` stacked on a leading axis) in one (H, W)
    image on the CPU: the per-pixel maximum of their layers, exact for
    disjoint faces; the noise as in ``render_face``."""
    X, Y = pixel_grid(hw, "cpu")
    skin, dark = _face_layers(torch.from_numpy(np.asarray(scenes.landmarks2d, np.float32)), X, Y)
    return _compose(skin.amax(0), dark.amax(0), _cpu_noise(hw, rng, noise)).numpy()


def landmark_heatmap_targets(uv_crop: torch.Tensor, map_hw: Tuple[int, int], stride: int = 4,
                             sigma: float = 1.0) -> torch.Tensor:
    """(..., 70, h, w) Gaussian targets from (..., 70, 2) crop-space
    landmark pixels, channel-first."""
    return crop_heatmaps(uv_crop, map_hw, stride, sigma)


def detector_targets(box: torch.Tensor, map_hw: Tuple[int, int], stride: int = 4, sigma: float = 2.0):
    """Centre-heatmap + log-size targets for ``FaceDetectorNet`` of (..., 4)
    boxes: (heat, logsize, weight), each (..., h, w). The heat is a
    Gaussian at the box centre, logsize = log(box side / stride),
    regressed only near the centre (weight = heat)."""
    X, Y = pixel_grid(map_hw, box.device)
    heat = gaussian_maps(X, Y, 0.5 * (box[..., :2] + box[..., 2:]) / float(stride) - 0.5, sigma)
    logsize = torch.log(torch.clamp((box[..., 2] - box[..., 0]) / float(stride), min=1e-3))
    return heat, logsize[..., None, None].expand(heat.shape), heat


class FaceDraws(NamedTuple):
    """The random draws of a ``make_face_batch`` batch."""
    scene: FaceScene                # stacked: landmarks2d (B, 70, 2), au02 (B,), ...
    noise: np.ndarray               # (B, H, W) standard normal: the render noise
    jitter: np.ndarray              # (B, 3) uniform [-1, 1): the box augmentation
    level: Optional[np.ndarray]     # (B,) uniform [0, 1): the pixel-noise level over pixel_noise
    pixel: Optional[np.ndarray]     # (B, H, W) standard normal: the pixel noise


def draw_face_batch(generator: np.random.Generator, batch: int, hw: Tuple[int, int] = (128, 128),
                    fx: float = 300.0, rot_range: float = 0.30, pixel_noise: float = 0.0) -> FaceDraws:
    scene = stack_scenes([sample_face(generator, hw, fx, fx, rot_range=rot_range) for _ in range(batch)])
    noise = generator.standard_normal((batch, *hw), dtype=np.float32)
    jitter = generator.uniform(-1.0, 1.0, (batch, 3)).astype(np.float32)
    level = pixel = None
    if pixel_noise > 0.0:
        level = generator.random(batch, dtype=np.float32)
        pixel = generator.standard_normal((batch, *hw), dtype=np.float32)
    return FaceDraws(scene, noise, jitter, level, pixel)


def draw_face_batch_from_key(key: np.ndarray, batch: int, hw: Tuple[int, int] = (128, 128), fx: float = 300.0,
                             rot_range: float = 0.30, pixel_noise: float = 0.0) -> FaceDraws:
    """The draws of the JAX package's ``make_face_batch(key, batch, ...)``
    for a JAX key (``utils.jax_random``): its split into ``batch`` keys,
    each split in three for the scene, the render noise (and, folded with
    7, the pixel-noise level, then folded with 1 its noise) and the box
    jitter."""
    k1, k2, k3 = np.moveaxis(jax_random.split(jax_random.split(key, batch), 3), -2, 0)
    scenes = stack_scenes([sample_face_from_key(k, hw, fx, fx, rot_range=rot_range) for k in k1])
    level = pixel = None
    if pixel_noise > 0.0:
        nk = jax_random.fold_in(k2, 7)
        level, pixel = jax_random.uniform(nk), jax_random.normal(jax_random.fold_in(nk, 1), hw)
    return FaceDraws(scenes, jax_random.normal(k2, hw), jax_random.uniform(k3, (3,), -1.0, 1.0), level, pixel)


def make_face_batch(generator: Optional[np.random.Generator], batch: int, hw: Tuple[int, int] = (128, 128),
                    crop: int = 96, fx: float = 300.0, rot_range: float = 0.30, pixel_noise: float = 0.0,
                    device="cuda", draws: Optional[FaceDraws] = None) -> dict:
    """A training batch on ``device``: "image" (B, H, W) renders in [0, 255],
    "crop" (B, 1, crop, crop) in [0, 1] through the jittered true box (at
    inference the crop comes from the detector, whose boxes differ from
    the landmarks' box), "heatmaps" (B, 70, crop/4, crop/4), "uv_crop"
    (B, 70, 2), "au" (B, 17) targets (5 x AU02's raise), the detector's
    "det_heat", "det_size", "det_weight" (B, H/4, W/4) from the true box,
    and "scene" (numpy). ``rot_range`` widens the head rotations and
    ``pixel_noise`` adds per-scene noise at a random level in
    [0, pixel_noise] of 255. The draws come from ``generator`` unless
    ``draws`` gives them."""
    from perception_tpu_torch.models.face import AU_NAMES
    from perception_tpu_torch.models.hand import crop_images

    if draws is None:
        draws = draw_face_batch(generator, batch, hw, fx, rot_range, pixel_noise)
    T = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    lm = T(draws.scene.landmarks2d)
    img = render_faces_batch(lm, hw, T(draws.noise))
    if pixel_noise > 0.0:
        lvl = T(draws.level)[:, None, None] * pixel_noise
        img = torch.clamp(img + T(draws.pixel) * lvl * 255.0, 0.0, 255.0)
    true_box = T(crop_box_from_landmarks(draws.scene.landmarks2d))
    det_heat, det_size, det_w = detector_targets(true_box, (hw[0] // 4, hw[1] // 4))
    box = jittered_boxes(true_box, T(draws.jitter))
    patch = crop_images(img, box, crop)
    sx = torch.full_like(box[:, 0], float(crop)) / (box[:, 2] - box[:, 0])
    uv_crop = (lm - box[:, None, :2]) * sx[:, None, None]
    maps = landmark_heatmap_targets(uv_crop, (crop // 4, crop // 4))
    au = torch.zeros((lm.shape[0], len(AU_NAMES)), device=device)
    au[:, AU_NAMES.index("AU02")] = 5.0 * T(draws.scene.au02)
    return {"image": img, "crop": (patch / 255.0)[:, None], "heatmaps": maps, "uv_crop": uv_crop, "au": au,
            "det_heat": det_heat, "det_size": det_size, "det_weight": det_w, "scene": draws.scene}
