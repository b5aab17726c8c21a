"""The tiny trained face fixture: landmark net, AU head and detector.

Counterpart of ``perception_tpu/models/face_fixture.py``. The weights are
the JAX package's ``tests/fixtures/facenet_tiny.msgpack``, read in place
by ``io.flax_msgpack`` (no flax needed) and mapped by
``convert.facenet_from_flax``, ``au_head_from_flax`` and
``face_detector_from_flax``; float16 in the file, float32 in the nets.
``load_fixture`` returns the three nets in a dict under the JAX
package's parameter keys: ``"landmark"``, ``"au"``, ``"det"``.
``init_tiny`` draws fresh nets (an ``nn.ModuleDict`` under those keys,
so they train as one module) from a JAX seed or a ``torch.Generator``,
and ``save_fixture`` writes them in the same format, which the JAX
package's ``load_fixture`` reads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

from torch import nn

from perception_tpu_torch.convert import (
    au_head_from_flax,
    au_head_to_flax,
    face_detector_from_flax,
    face_detector_to_flax,
    facenet_from_flax,
    facenet_to_flax,
)
from perception_tpu_torch.io.flax_msgpack import read_tree, write_tree
from perception_tpu_torch.models.face import ActionUnitHead, FaceLandmarkNet, decode_landmarks, normalize_landmarks
from perception_tpu_torch.models.face_detect import FaceDetectorNet, decode_detector_net
from perception_tpu_torch.models.pose import flax_init_
from perception_tpu_torch.models.pose_fixture import _half
from perception_tpu_torch.utils import jax_random

FIXTURE_HW = (128, 128)     # full-image render size used in training
FIXTURE_CROP = 96           # landmark-net input crop
FIXTURE_FX = 300.0
FIXTURE_PATH = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "facenet_tiny.msgpack"


def tiny_facenet() -> FaceLandmarkNet:
    """The fixture's landmark net: width 24 (~0.2 M parameters)."""
    return FaceLandmarkNet(width=24)


def tiny_au_head() -> ActionUnitHead:
    return ActionUnitHead(hidden=64)


def tiny_detector() -> FaceDetectorNet:
    return FaceDetectorNet(features=(16, 32, 64))


_CONVERTERS = (("landmark", facenet_to_flax, facenet_from_flax), ("au", au_head_to_flax, au_head_from_flax),
               ("det", face_detector_to_flax, face_detector_from_flax))


def init_tiny(seed: Union[int, torch.Generator], device="cuda") -> nn.ModuleDict:
    """Fresh fixture nets {"landmark", "au", "det"} with flax's default
    initialisation, ready to train. ``seed`` is a JAX seed (an int): the
    weights of the JAX package's ``init_tiny(jax.random.key(seed))``, drawn
    by ``utils.jax_random`` (equal but for a few weights one or two ulps
    apart); or a ``torch.Generator`` (a CPU generator) to draw from, in
    that order. (The JAX function takes a key; this one an int or a
    generator.)"""
    nets = nn.ModuleDict({"landmark": tiny_facenet(), "au": tiny_au_head(), "det": tiny_detector()})
    if isinstance(seed, torch.Generator):
        for key, _, _ in _CONVERTERS:
            flax_init_(nets[key], seed)
        return nets.to(device)
    keys = jax_random.split(jax_random.key(seed), 3)
    with torch.no_grad():
        for (key, to_flax, from_flax), k in zip(_CONVERTERS, keys):
            tree = jax_random.flax_init_params(to_flax(nets[key]), k)
            nets[key].load_state_dict(from_flax(tree, nets[key], "cpu"))
    return nets.to(device)


def save_fixture(nets, path=FIXTURE_PATH) -> None:
    """Write the three nets as the JAX package's ``save_fixture`` does
    (float16 flax trees under "landmark", "au", "det")."""
    write_tree(path, _half({"landmark": facenet_to_flax(nets["landmark"]), "au": au_head_to_flax(nets["au"]),
                            "det": face_detector_to_flax(nets["det"])}))


def load_fixture(device="cuda", path=FIXTURE_PATH) -> dict:
    """The trained nets on ``device``, in eval mode: {"landmark", "au", "det"}."""
    tree = read_tree(path)
    nets = {}
    for key, make, convert in (("landmark", tiny_facenet, facenet_from_flax), ("au", tiny_au_head, au_head_from_flax),
                               ("det", tiny_detector, face_detector_from_flax)):
        net = make()
        net.load_state_dict(convert(tree[key], net, device), assign=True)
        nets[key] = net.requires_grad_(False).eval()
    return nets


def fixture_available() -> bool:
    return FIXTURE_PATH.exists()


@torch.no_grad()
def detect_with_net(det_net: FaceDetectorNet, gray: torch.Tensor, threshold: float = 0.3, max_faces: int = 4):
    """Gray (H, W) in [0, 255] -> FaceDetections through the trained
    detector (its heat was trained against a [0, 1] Gaussian, so the peak
    threshold is on that scale). The input is scaled by a multiply by
    1/255, as XLA compiles ``gray / 255.0``."""
    heat, size = det_net((gray * (1.0 / 255.0))[None, None])
    return decode_detector_net(heat[0], size[0], threshold=threshold, max_faces=max_faces)


@torch.no_grad()
def landmarks_from_crop(lm_net: FaceLandmarkNet, patch: torch.Tensor, box: torch.Tensor):
    """Crops (..., S, S) in [0, 1] + their image-space boxes (..., 4) ->
    image-space landmarks (..., 70, 2), validity and scores, in one net call."""
    lead, S = box.shape[:-1], patch.shape[-1]
    maps = lm_net(patch.reshape(-1, 1, S, S))
    return decode_landmarks(maps.reshape(lead + maps.shape[1:]), box)


def evaluate(params: dict, rng: Union[np.random.Generator, np.ndarray], n_scenes: int = 16,
             rot_range: float = 0.30, z_range=(0.45, 0.75), pixel_noise: float = 0.0,
             device="cuda") -> Tuple[float, float, float]:
    """(mean landmark error in image px on the true crops, AU02 separation =
    the least intensity on raised brows - the most on neutral ones, mean
    detector IoU against the true face box) over ``n_scenes`` scenes: each
    a ``sample_face``, its noisy render, and with ``pixel_noise`` more
    noise of that fraction of 255. ``rng`` is a numpy generator to draw
    them from, or a JAX key (``utils.jax_random``): the scenes and noise
    of the JAX package's ``evaluate(params, key)``, scene i from
    ``fold_in(key, i)`` split in two."""
    from perception_tpu_torch.models.face import iou
    from perception_tpu_torch.models.face_data import (
        crop_box_from_landmarks,
        render_face,
        sample_face,
        sample_face_from_key,
    )
    from perception_tpu_torch.models.hand import crop_image

    errs, raised, neutral, ious = [], [], [], []
    for i in range(n_scenes):
        if isinstance(rng, np.random.Generator):
            scene = sample_face(rng, FIXTURE_HW, FIXTURE_FX, FIXTURE_FX, rot_range=rot_range, z_range=z_range)
            img = render_face(scene, FIXTURE_HW, rng=rng)
            if pixel_noise > 0.0:
                extra = rng.standard_normal(img.shape).astype(np.float32)
        else:
            k1, k2 = jax_random.split(jax_random.fold_in(rng, i))
            scene = sample_face_from_key(k1, FIXTURE_HW, FIXTURE_FX, FIXTURE_FX, rot_range=rot_range, z_range=z_range)
            img = render_face(scene, FIXTURE_HW, noise=jax_random.normal(k2, FIXTURE_HW))
            if pixel_noise > 0.0:
                extra = jax_random.normal(jax_random.fold_in(k2, 99), img.shape)
        if pixel_noise > 0.0:
            img = np.clip(img + extra * np.float32(pixel_noise * 255.0), np.float32(0.0), np.float32(255.0))
        box_np = crop_box_from_landmarks(scene.landmarks2d)
        gray, box = torch.from_numpy(img).to(device), torch.from_numpy(box_np).to(device)
        uv, m, _ = landmarks_from_crop(params["landmark"], crop_image(gray, box, FIXTURE_CROP) / 255.0, box)
        e = np.linalg.norm(uv.cpu().numpy() - scene.landmarks2d, axis=-1)
        errs.append(float(np.mean(e[m.cpu().numpy()])) if bool(m.any()) else float("nan"))
        with torch.no_grad():
            inten, _ = params["au"](normalize_landmarks(uv, m))
        (raised if float(scene.au02) > 0.5 else neutral).append(float(inten[1]))  # AU02
        det = detect_with_net(params["det"], gray)
        ious.append(float(iou(det.boxes[0], box)) if bool(det.mask[0]) else 0.0)
    sep = (min(raised) - max(neutral)) if raised and neutral else float("nan")
    return float(np.nanmean(errs)), sep, float(np.mean(ious))
