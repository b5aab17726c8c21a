"""Facade throughput: the whole ``Perception`` wrapper (pose, multi-face
and both hands) a frame.

Counterpart of ``benchmarks/facade_bench.py``'s ``run``: the trained
fixtures (MPI_15 pose at its 128x128 net size, 4 face slots, hands of the
top 2 people) on a three-face scene at ``hw``, 8 renders with their own
noise staged on the device beforehand, then ``frames`` calls of
``emplace_and_pop`` after a warm-up call. The scene is the JAX
benchmark's: its faces and noise are drawn from the JAX package's keys
(``key(0)`` folded with the face index, and with 100 + the render index)
through ``utils/jax_random``. It reports

  facade_fps     frames/s (host clock, ending in a synchronize on the card)
  faces_tracked  faces in the warm-up call's datum

and the frame count, resolution and extractors. ``cli bench`` reports it
under ``extra["facade"]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import sync

OFFSETS = ((-0.14, -0.14), (0.14, -0.14), (0.0, 0.14))  # metres, at depth Z
Z = 0.62
STAGED = 8


def staged_frames(hw=(256, 256)) -> np.ndarray:
    """The benchmark's STAGED three-face RGB frames, (STAGED, H, W, 3)
    float32 in [0, 255]."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face_data import render_faces, sample_face_at_from_key, stack_scenes
    from perception_tpu_torch.utils import jax_random

    key = jax_random.key(0)
    scenes = stack_scenes([
        sample_face_at_from_key(jax_random.fold_in(key, i), hw, FF.FIXTURE_FX, FF.FIXTURE_FX, o, Z)
        for i, o in enumerate(OFFSETS)
    ])
    grays = [render_faces(scenes, hw, noise=jax_random.normal(jax_random.fold_in(key, 100 + t), hw))
             for t in range(STAGED)]
    return np.repeat(np.stack(grays)[..., None], 3, axis=-1).astype(np.float32)


def run(frames: int = 120, hw=(256, 256), device="cuda") -> dict:
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models import hand_fixture as HF
    from perception_tpu_torch.models import pose_fixture as PF
    from perception_tpu_torch.wrapper import Perception, WrapperStructFace, WrapperStructHand, WrapperStructPose

    if not (PF.fixture_available() and FF.fixture_available() and HF.fixture_available()):
        raise RuntimeError("trained fixtures missing")
    engine = Perception(
        pose=WrapperStructPose(topology=PF.FIXTURE_TOPOLOGY, net_hw=PF.FIXTURE_HW),
        face=WrapperStructFace(enabled=True, max_faces=4),
        hand=WrapperStructHand(enabled=True, top_n_people=2),
        device=device,
    )
    imgs = torch.from_numpy(staged_frames(hw)).to(device)
    sync(imgs)

    d = engine.emplace_and_pop(imgs[0], frame_index=0)
    n_faces = int(d.faces["mask"].sum())

    t0 = time.perf_counter()
    last = None
    for t in range(frames):
        last = engine.emplace_and_pop(imgs[t % STAGED], frame_index=t + 1)
    sync((last.people.keypoints, last.faces["landmarks"]))
    dt = time.perf_counter() - t0
    return {
        "facade_fps": frames / dt,
        "frames": frames,
        "resolution": f"{hw[1]}x{hw[0]}",
        "faces_tracked": n_faces,
        "extractors": "pose+face(x4 slots)+hands(2 people x L/R)",
    }
