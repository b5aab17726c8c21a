"""The port's ``Perception`` facade (``wrapper.py``) against the JAX
package's on the CPU.

Both load the repo's trained fixtures (the MPI_15 pose net at 128x128,
the face nets, the hand net) the way their wrappers do when ``params`` is
None. Tolerances, on the same frames:

- construction: the same checks raise the same messages;
- ``emplace_and_pop`` pose only (``top_n`` 2) on two fixture scenes in
  [0, 1], and pose + face + hands on ``facade_bench.py``'s 256x256
  three-face frames in [0, 255] (``chip_smoke.three_faces``), two frames
  with the detector on every second one (``detect_every=2``): the same
  people, part counts and peaks, keypoints within 1e-3 px, scores within
  1e-4; the same face slots, masks and gates, face boxes and landmarks
  within 1e-3 px, head poses within 1e-4; the same hand boxes' validity
  and landmark masks, hand boxes and landmarks within 1e-2 px (the boxes
  move with the keypoints);
- ``exec`` over an array source with the JSON sink: the files of both
  packages name the same people with keypoints within 1e-3 px; async
  ``start`` / ``wait_and_pop`` / ``stop`` yield every frame in order.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from perception_tpu import wrapper as jw
from perception_tpu_torch import wrapper as tw
from perception_tpu_torch.models import pose_fixture

torch.set_num_threads(2)


def np_of(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def compare_people(got, want):
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(np_of(got.num_parts), np.asarray(want.num_parts))
    np.testing.assert_array_equal(np_of(got.keypoints)[..., 2] > 0, np.asarray(want.keypoints)[..., 2] > 0)
    np.testing.assert_allclose(np_of(got.keypoints), np.asarray(want.keypoints), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_of(got.score), np.asarray(want.score), rtol=0, atol=1e-4)


def compare_datum(got, want):
    compare_people(got.people, want.people)
    if want.faces is not None:
        for key in ("mask", "landmark_mask", "ok", "pose_gate"):
            np.testing.assert_array_equal(np_of(got.faces[key]), np.asarray(want.faces[key]), err_msg=key)
        for key, tol in (("boxes", 1e-3), ("landmarks", 1e-3), ("head_pose", 1e-4)):
            np.testing.assert_allclose(np_of(got.faces[key]), np.asarray(want.faces[key]), rtol=0, atol=tol,
                                       err_msg=key)
    if want.hands is not None:
        for key in ("box_valid", "landmark_mask"):
            np.testing.assert_array_equal(np_of(got.hands[key]), np.asarray(want.hands[key]), err_msg=key)
        for key in ("boxes", "landmarks"):
            np.testing.assert_allclose(np_of(got.hands[key]), np.asarray(want.hands[key]), rtol=0, atol=1e-2,
                                       err_msg=key)


def test_sanity_checks_match_jax():
    cases = [
        (dict(pose=dict(enabled=False)), "no extractor"),
        (dict(pose=dict(enabled=False), face=dict(enabled=True), hand=dict(enabled=True)), "hand extraction needs pose"),
        (dict(pose=dict(net_hw=(100, 100))), "multiples of 8"),
        (dict(pose=dict(scales=())), "scale"),
        (dict(pose=dict(top_n=-1)), "top_n"),
        (dict(face=dict(enabled=True, max_faces=0)), "max_faces"),
        (dict(face=dict(enabled=True, detect_every=0)), "detect_every"),
        (dict(hand=dict(enabled=True, top_n_people=0)), "top_n_people"),
        (dict(input=dict(source=[], fps_keep=-1.0)), "fps_keep"),
        (dict(input=dict(frame_limit=0)), "frame_limit"),
        (dict(output=dict(video_path="out.xyz")), "video container"),
    ]
    structs = {"pose": "WrapperStructPose", "face": "WrapperStructFace", "hand": "WrapperStructHand",
               "input": "WrapperStructInput", "output": "WrapperStructOutput"}
    for kwargs, message in cases:
        errors = []
        for mod, extra in ((jw, {}), (tw, {"device": "cpu"})):
            args = {k: getattr(mod, structs[k])(**v) for k, v in kwargs.items()}
            with pytest.raises(ValueError, match=message) as e:
                mod.Perception(**args, **extra)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    for name in ("WrapperStructPose", "WrapperStructFace", "WrapperStructHand", "WrapperStructInput",
                 "WrapperStructOutput", "WrapperStructGui"):
        assert [(f.name, f.default) for f in dataclasses.fields(getattr(tw, name))] == \
            [(f.name, f.default) for f in dataclasses.fields(getattr(jw, name))]
    assert tw.PerceptionDatum._fields == jw.PerceptionDatum._fields


def test_emplace_and_pop_pose_only_matches_jax():
    _, images = pose_fixture.sample_scenes(np.random.default_rng(chip_smoke.POSE_SEED), 2)
    pose = dict(topology="MPI_15", net_hw=(128, 128), top_n=2)
    jp = jw.Perception(pose=jw.WrapperStructPose(**pose))
    tp = tw.Perception(pose=tw.WrapperStructPose(**pose), device="cpu")
    for i, img in enumerate(images):
        got, want = tp.emplace_and_pop(img, frame_index=i), jp.emplace_and_pop(img, frame_index=i)
        compare_datum(got, want)
        assert got.faces is None and got.hands is None and int(np_of(got.people.mask).sum()) <= 2
        assert isinstance(got.image, np.ndarray) and got.frame_index == i


@pytest.fixture(scope="module")
def facade_frames():
    return chip_smoke.rgb(chip_smoke.three_faces(chip_smoke.FACADE_SEED, n=2)[1])


def test_facade_pose_face_hands_matches_jax(facade_frames):
    face, hand = dict(enabled=True, max_faces=4, detect_every=2), dict(enabled=True, top_n_people=2)
    jp = jw.Perception(face=jw.WrapperStructFace(**face), hand=jw.WrapperStructHand(**hand))
    tp = tw.Perception(face=tw.WrapperStructFace(**face), hand=tw.WrapperStructHand(**hand), device="cpu")
    for i, img in enumerate(facade_frames):
        got, want = tp.emplace_and_pop(img, frame_index=i), jp.emplace_and_pop(img, frame_index=i)
        compare_datum(got, want)
        assert int(np_of(got.faces["mask"]).sum()) == 3  # frame 1: the detector throttled, the faces carried
        assert got.faces["head_pose"].shape == (4, 4, 4) and got.hands["landmarks"].shape == (2, 2, 21, 2)
    # A frame given as a tensor stays a tensor in the datum.
    d = tp.emplace_and_pop(torch.from_numpy(facade_frames[0]))
    assert isinstance(d.image, torch.Tensor) and int(d.faces["mask"].sum()) == 3


def read_people(directory):
    return {p.name: json.loads(p.read_text()) for p in sorted(directory.iterdir())}


def test_exec_json_sink_and_async_match_jax(tmp_path):
    _, images = pose_fixture.sample_scenes(np.random.default_rng(3), 3)
    frames = list(images)
    for mod, name, extra in ((jw, "jax", {}), (tw, "torch", {"device": "cpu"})):
        p = mod.Perception(pose=mod.WrapperStructPose(topology="MPI_15", net_hw=(128, 128)),
                           input=mod.WrapperStructInput(source=frames, frame_limit=2),
                           output=mod.WrapperStructOutput(json_dir=str(tmp_path / name)), **extra)
        data = list(p.exec())
        assert [d.frame_index for d in data] == [0, 1]
    got, want = read_people(tmp_path / "torch"), read_people(tmp_path / "jax")
    assert list(got) == list(want) == ["people_000000.json", "people_000001.json"]
    for k in got:
        assert [p["person_id"] for p in got[k]["people"]] == [p["person_id"] for p in want[k]["people"]]
        assert len(got[k]["people"]) > 0
        for a, b in zip(got[k]["people"], want[k]["people"]):
            np.testing.assert_allclose(a["pose_keypoints_2d"], b["pose_keypoints_2d"], rtol=0, atol=1e-3)

    p = tw.Perception(pose=tw.WrapperStructPose(topology="MPI_15", net_hw=(128, 128)),
                      input=tw.WrapperStructInput(source=np.stack(frames)), device="cpu")
    p.start()
    got = []
    while True:
        d = p.wait_and_pop(timeout=60.0)
        if d is None:
            break
        got.append(d)
    p.stop()
    assert [d.frame_index for d in got] == [0, 1, 2]
    assert p.try_pop() is None and p._thread is None
