"""The tiny trained PoseNet fixture: config, loading and PCK evaluation.

Counterpart of ``perception_tpu/models/pose_fixture.py``. The weights are
the JAX package's ``tests/fixtures/posenet_mpi15_tiny.msgpack``, read in
place by ``io.flax_msgpack`` (no flax needed) and mapped by
``convert.posenet_from_flax``; float16 in the file, float32 in the net.
``init_tiny`` draws a fresh net and ``save_fixture`` writes one in the
same format (``convert.posenet_to_flax``, rounded to float16), which the
JAX package's ``load_fixture`` reads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

from perception_tpu_torch.convert import posenet_from_flax, posenet_to_flax
from perception_tpu_torch.io.flax_msgpack import read_tree, write_tree
from perception_tpu_torch.models.pose import PoseNet, extract_people, flax_init_
from perception_tpu_torch.models.pose_data import (SkeletonScene, draw_batch_from_key, render_people, sample_skeletons,
                                                   stack_scenes)

FIXTURE_HW = (128, 128)
FIXTURE_TOPOLOGY = "MPI_15"
FIXTURE_PATH = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "posenet_mpi15_tiny.msgpack"
# extract_people's settings for the fixture (the JAX package's pck_on_images).
FIXTURE_DECODE = dict(peak_threshold=0.2, min_person_parts=5)


def tiny_posenet() -> PoseNet:
    """The fixture architecture: a 2-stage PoseNet."""
    return PoseNet(
        num_parts=15, num_limbs=14, num_stages=2,
        backbone_widths=(16, 24, 32), stage_width=64, stage_depth=3,
    )


def init_tiny(generator: torch.Generator, device="cuda") -> PoseNet:
    """A fresh fixture net with flax's default initialisation drawn from
    ``generator`` (a CPU generator), ready to train."""
    return flax_init_(tiny_posenet(), generator).to(device)


def _half(tree):
    return {k: _half(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree, np.float16)


def save_fixture(net: PoseNet, path=FIXTURE_PATH) -> None:
    """Write ``net`` as the JAX package's ``save_fixture`` does: its flax
    tree in float16, serialised by flax's msgpack."""
    write_tree(path, _half(posenet_to_flax(net)))


def load_fixture(device="cuda", path=FIXTURE_PATH) -> PoseNet:
    """The trained tiny PoseNet on ``device``, in eval mode."""
    net = tiny_posenet()
    net.load_state_dict(posenet_from_flax(read_tree(path), net, device), assign=True)
    return net.requires_grad_(False).eval()


def fixture_available() -> bool:
    return FIXTURE_PATH.exists()


def extract_fixture_people(net: PoseNet, images: torch.Tensor):
    """``extract_people`` as the fixture is evaluated: (B, 128, 128, 3)."""
    return extract_people(net, images, topology=FIXTURE_TOPOLOGY, net_hw=FIXTURE_HW, **FIXTURE_DECODE)


def pck_of_people(keypoints, person_mask, scenes, tol_px: float = 10.0, stride: int = 8) -> Tuple[float, float]:
    """PCK and person recall of detected people against the scenes' joints.

    ``keypoints`` (B, Pmax, P, 3) and ``person_mask`` (B, Pmax) as numpy;
    ``scenes`` joints (B, N, P, 2), valid (B, N). A true joint counts as hit
    by its best-matching detected person's keypoint within ``tol_px``
    after the bilinear resize's half-pixel shift (stride/2 - 0.5); a
    person is found with at least 5 hits.
    """
    hits = total = found_people = total_people = 0
    for i in range(keypoints.shape[0]):
        kp, pmask = keypoints[i], person_mask[i]
        gt, gvalid = np.asarray(scenes.joints[i]), np.asarray(scenes.valid[i])
        for n in range(gt.shape[0]):
            if not gvalid[n]:
                continue
            total_people += 1
            total += gt.shape[1]
            best, best_hits = -1, 0
            for m in range(kp.shape[0]):
                if not pmask[m]:
                    continue
                pred = kp[m, :, :2] - (stride / 2.0 - 0.5)
                present = kp[m, :, 2] > 0
                d = np.linalg.norm(pred - gt[n], axis=-1)
                h = int(((d < tol_px) & present).sum())
                if h > best_hits:
                    best_hits, best = h, m
            if best >= 0 and best_hits >= 5:
                found_people += 1
            hits += best_hits
    return hits / max(total, 1), found_people / max(total_people, 1)


def pck_on_images(net: PoseNet, images, scenes, tol_px: float = 10.0, stride: int = 8, device="cuda"):
    """PCK and recall on caller-provided images (B, 128, 128, 3) and scenes,
    all images in one batched ``extract_people`` call."""
    x = torch.as_tensor(np.asarray(images, np.float32)).to(device)
    ppl = extract_fixture_people(net, x)
    return pck_of_people(ppl.keypoints.cpu().numpy(), ppl.mask.cpu().numpy(), scenes, tol_px, stride)


def sample_scenes(generator: np.random.Generator, n_scenes: int, hw=FIXTURE_HW):
    """``n_scenes`` skeleton scenes from ``generator`` and their renders:
    (stacked SkeletonScene, images (n, H, W, 3))."""
    scenes = [sample_skeletons(generator, hw) for _ in range(n_scenes)]
    return stack_scenes(scenes), np.stack([render_people(s, hw) for s in scenes])


def evaluate_pck(net: PoseNet, generator: Union[np.random.Generator, np.ndarray], n_scenes: int = 8,
                 tol_px: float = 10.0, stride: int = 8, device="cuda") -> Tuple[float, float]:
    """PCK and recall on fresh synthetic scenes drawn from ``generator``, or
    from a JAX key (``utils.jax_random``): the scenes of the JAX package's
    ``evaluate_pck(params, key, ...)``, rendered by the port."""
    if isinstance(generator, np.random.Generator):
        scenes, images = sample_scenes(generator, n_scenes)
    else:
        scenes = draw_batch_from_key(generator, n_scenes, FIXTURE_HW).scene
        images = np.stack([render_people(SkeletonScene(j, v), FIXTURE_HW) for j, v in zip(scenes.joints, scenes.valid)])
    return pck_on_images(net, images, scenes, tol_px=tol_px, stride=stride, device=device)
