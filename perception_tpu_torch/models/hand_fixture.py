"""The tiny trained hand fixture: config, loading and evaluation.

Counterpart of ``perception_tpu/models/hand_fixture.py``. The weights are
the JAX package's ``tests/fixtures/handnet_tiny.msgpack``, read in place
by ``io.flax_msgpack`` (no flax needed) and mapped by
``convert.handnet_from_flax``; float16 in the file, float32 in the net.
``init_tiny`` draws a fresh net and ``save_fixture`` writes one in the
same format, which the JAX package's ``load_fixture`` reads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.convert import handnet_from_flax, handnet_to_flax
from perception_tpu_torch.io.flax_msgpack import read_tree, write_tree
from perception_tpu_torch.models.face import decode_landmarks
from perception_tpu_torch.models.hand import LEFT_ARM, RIGHT_ARM, HandLandmarkNet, crop_image, hand_roi_from_pose
from perception_tpu_torch.models.hand_data import hand_box, render_hand, sample_hand
from perception_tpu_torch.models.pose import flax_init_
from perception_tpu_torch.models.pose_fixture import _half

FIXTURE_HW = (96, 96)
FIXTURE_CROP = 64
FIXTURE_PATH = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "handnet_tiny.msgpack"


def tiny_handnet() -> HandLandmarkNet:
    return HandLandmarkNet(width=24)


def init_tiny(generator: torch.Generator, device="cuda") -> HandLandmarkNet:
    """A fresh fixture net with flax's default initialisation drawn from
    ``generator`` (a CPU generator), ready to train."""
    return flax_init_(tiny_handnet(), generator).to(device)


def save_fixture(net: HandLandmarkNet, path=FIXTURE_PATH) -> None:
    """Write ``net`` as the JAX package's ``save_fixture`` does (float16)."""
    write_tree(path, _half(handnet_to_flax(net)))


def load_fixture(device="cuda", path=FIXTURE_PATH) -> HandLandmarkNet:
    """The trained tiny hand net on ``device``, in eval mode."""
    net = tiny_handnet()
    net.load_state_dict(handnet_from_flax(read_tree(path), net, device), assign=True)
    return net.requires_grad_(False).eval()


def fixture_available() -> bool:
    return FIXTURE_PATH.exists()


@torch.no_grad()
def extract_hand_tiny(net: HandLandmarkNet, image: torch.Tensor, box: torch.Tensor):
    """Gray image (H, W) in [0, 255] + (..., 4) boxes -> (landmarks (..., 21, 2)
    image px, mask, scores) through the fixture-sized net."""
    patch = crop_image(image, box, FIXTURE_CROP) / const(255.0, image)
    lead = box.shape[:-1]
    hm = net(patch.reshape(-1, 1, FIXTURE_CROP, FIXTURE_CROP))
    return decode_landmarks(hm.reshape(lead + hm.shape[1:]), box)


@torch.no_grad()
def hands_from_pose(net: HandLandmarkNet, gray: torch.Tensor, keypoints: torch.Tensor,
                    people_mask: torch.Tensor, n_people: int = 1) -> dict:
    """The facade's hand step (``perception_tpu/wrapper.py``'s ``hand_fn``):
    left and right hand boxes of the first ``n_people`` people, one
    batched crop and one net call over the 2N boxes, then the landmark
    decode. ``gray`` (H, W) in [0, 255]; ``keypoints`` (Pmax, P, 3) and
    ``people_mask`` (Pmax,) as ``extract_people`` gives them (BODY_25 or
    MPI_15 arm ids). Returns boxes (N, 2, 4) [left, right], box_valid
    (N, 2), landmarks (N, 2, 21, 2) and landmark_mask (N, 2, 21)."""
    kp = keypoints[:n_people]
    pm = people_mask[:n_people]
    bl, okl = hand_roi_from_pose(kp, arm=LEFT_ARM)
    br, okr = hand_roi_from_pose(kp, arm=RIGHT_ARM)
    boxes = torch.stack([bl, br], dim=-2)
    valid = torch.stack([okl, okr], dim=-1) & pm[:, None]
    uv, m, _ = extract_hand_tiny(net, gray, boxes)
    return {"boxes": boxes, "box_valid": valid, "landmarks": uv, "landmark_mask": m & valid[..., None]}


def sample_scenes(generator: np.random.Generator, n_scenes: int, hw=FIXTURE_HW):
    """``n_scenes`` hand scenes and their noisy renders, drawn from
    ``generator`` in turn: a list of (HandScene, image (H, W))."""
    out = []
    for _ in range(n_scenes):
        scene = sample_hand(generator, hw)
        out.append((scene, render_hand(scene, hw, rng=generator)))
    return out


def evaluate(net: HandLandmarkNet, generator: np.random.Generator, n_scenes: int = 12,
             device="cuda") -> float:
    """Mean landmark error (image px) over fresh scenes with their true
    boxes (``sample_scenes``)."""
    errs = []
    for scene, img in sample_scenes(generator, n_scenes):
        box = torch.from_numpy(hand_box(scene.joints)).to(device)
        uv, m, _ = extract_hand_tiny(net, torch.from_numpy(img).to(device), box)
        e = np.linalg.norm(uv.cpu().numpy() - scene.joints, axis=-1)
        errs.append(float(np.mean(np.where(m.cpu().numpy(), e, np.nan))))
    return float(np.nanmean(errs))
