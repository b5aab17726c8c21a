"""The port's multi-face slots (``models/face_multi.py``) against the JAX
package on the CPU.

Same numpy inputs through both; the JAX side's weights from
``flax.serialization.msgpack_restore`` of ``facenet_tiny.msgpack``, the
port's from its own reader. Tolerances:

- ``assign_detections`` and ``retire_failed_tracks`` (the JAX package's
  unit cases, and random boxes with ties): states equal;
- ``multi_face_step`` (jitted there) on ``tests/test_face_multi.py``'s
  three-face 256x256 scene from ``chip_smoke.three_faces`` with four
  slots, ``detect`` True, then False twice: slots, masks, ``ok`` and the
  AU02 gates equal, boxes and landmarks within 1e-3 px, head poses within
  1e-4, AU intensities within 1e-4; the JAX state after the first frame,
  through ``convert.face_tracks_from_jax``, gives the port's next frame;
- ``detect`` as a host False (the detector skipped) and as a tensor
  False (run and masked) give identical outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from perception_tpu.models import face_fixture as jff
from perception_tpu.models import face_multi as jfm
from perception_tpu_torch.convert import face_tracks_from_jax
from perception_tpu_torch.models import face_fixture, face_multi

torch.set_num_threads(2)
FX = face_fixture.FIXTURE_FX
CX, CY = chip_smoke.MULTI_HW[1] / 2.0, chip_smoke.MULTI_HW[0] / 2.0


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


def assert_state(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                        serialization.msgpack_restore(jff.FIXTURE_PATH.read_bytes()))


@pytest.fixture(scope="module")
def nets():
    return face_fixture.load_fixture("cpu")


@pytest.fixture(scope="module")
def jax_run(jax_params):
    """The JAX package's three frames (detect, then throttled twice) on
    the smoke's three-face scene: (image, [(state, outputs)])."""
    img = chip_smoke.three_faces(chip_smoke.MULTI_SEED)[1][0]
    state, out = jfm.init_tracks(chip_smoke.MULTI_SLOTS), []
    for detect in (True, False, False):
        state, o = jfm.multi_face_step(jax_params, jnp.asarray(img), state, FX, FX, CX, CY, jnp.bool_(detect))
        out.append((jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in o.items()}))
    return img, out


def test_assign_and_retire_match_jax():
    det = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]], np.float32)
    mask = np.asarray([True, False, True])
    got = face_multi.assign_detections(face_multi.init_tracks(4, "cpu"), T(det), T(mask))
    want = jfm.assign_detections(jfm.init_tracks(4), jnp.asarray(det), jnp.asarray(mask))
    assert_state(got, want)
    assert np_of(got.active).tolist() == [True, True, False, False]
    np.testing.assert_array_equal(np_of(got.boxes[1]), det[2])  # rank-matched

    # Refresh: the same face moved a little refreshes its slot.
    st = face_multi.assign_detections(face_multi.init_tracks(2, "cpu"), T([[10, 10, 50, 50.0]]), T([True]))
    jst = jfm.assign_detections(jfm.init_tracks(2), jnp.asarray([[10, 10, 50, 50.0]]), jnp.asarray([True]))
    st = face_multi.assign_detections(st, T([[12, 12, 52, 52.0]]), T([True]))
    jst = jfm.assign_detections(jst, jnp.asarray([[12, 12, 52, 52.0]]), jnp.asarray([True]))
    assert_state(st, jst)
    assert np_of(st.active).tolist() == [True, False]

    # Random boxes over random slots, with duplicated detections (ties).
    rng = np.random.default_rng(0)
    for _ in range(6):
        boxes = (rng.random((5, 4)) * 60).astype(np.float32)
        boxes[:, 2:] += boxes[:, :2] + 10
        active = rng.random(5) > 0.5
        fails = rng.integers(0, 6, 5).astype(np.int32)
        det = np.concatenate([boxes[rng.integers(0, 5, 3)] + rng.normal(0, 2, (3, 4)).astype(np.float32),
                              (rng.random((3, 4)) * 60).astype(np.float32) + [0, 0, 15, 15]]).astype(np.float32)
        det[4] = det[3]
        dmask = rng.random(6) > 0.2
        jstate = jfm.FaceTrackState(jnp.asarray(boxes), jnp.asarray(active), jnp.asarray(fails))
        state = face_multi.FaceTrackState(T(boxes), T(active), T(fails))
        assert_state(face_multi.assign_detections(state, T(det), T(dmask)),
                     jfm.assign_detections(jstate, jnp.asarray(det), jnp.asarray(dmask)))
        ok = rng.random(5) > 0.5
        assert_state(face_multi.retire_failed_tracks(state, T(ok)), jfm.retire_failed_tracks(jstate, jnp.asarray(ok)))

    # Retirement after more than MAX_TRACK_FAILS failures in a row.
    st = face_multi.assign_detections(face_multi.init_tracks(1, "cpu"), T([[0, 0, 10, 10.0]]), T([True]))
    for _ in range(face_multi.MAX_TRACK_FAILS):
        st = face_multi.retire_failed_tracks(st, T([False]))
        assert bool(st.active[0])
    st = face_multi.retire_failed_tracks(st, T([False]))
    assert not bool(st.active[0])


def compare(got, want):
    for key in ("mask", "landmark_mask", "ok", "pose_gate"):
        np.testing.assert_array_equal(np_of(got[key]), want[key], err_msg=key)
    for key, tol in (("boxes", 1e-3), ("landmarks", 1e-3), ("head_pose", 1e-4), ("gaze", 1e-4),
                     ("au_intensities", 1e-4), ("reproj_px", 1e-3)):
        np.testing.assert_allclose(np_of(got[key]), want[key], rtol=0, atol=tol, err_msg=key)


def test_multi_face_step_matches_jax(nets, jax_run):
    img, frames = jax_run
    state = face_multi.init_tracks(chip_smoke.MULTI_SLOTS, "cpu")
    for (jstate, jout), detect in zip(frames, (True, False, False)):
        state, out = face_multi.multi_face_step(nets, T(img), state, FX, FX, CX, CY, detect)
        compare(out, jout)
        np.testing.assert_array_equal(np_of(state.active), jstate.active)
        np.testing.assert_array_equal(np_of(state.fails), jstate.fails)
        np.testing.assert_allclose(np_of(state.boxes), jstate.boxes, rtol=0, atol=1e-3)
    assert int(frames[0][1]["mask"].sum()) == 3 and np.array_equal(frames[2][1]["ok"], frames[2][1]["mask"])


def test_converted_state_continues_as_jax(nets, jax_run):
    img, frames = jax_run
    state = face_tracks_from_jax(frames[0][0], device="cpu")
    assert state.fails.dtype == torch.int32 and state.active.dtype == torch.bool
    _, out = face_multi.multi_face_step(nets, T(img), state, FX, FX, CX, CY, False)
    compare(out, frames[1][1])


def test_throttled_frame_skips_the_detector_with_the_same_outputs(nets, jax_run, monkeypatch):
    img, _ = jax_run
    state, _ = face_multi.multi_face_step(nets, T(img), face_multi.init_tracks(chip_smoke.MULTI_SLOTS, "cpu"),
                                          FX, FX, CX, CY, True)
    calls, real = [], face_fixture.detect_with_net
    monkeypatch.setattr(face_fixture, "detect_with_net", lambda *a, **k: calls.append(1) or real(*a, **k))
    skipped = face_multi.multi_face_step(nets, T(img), state, FX, FX, CX, CY, False)
    masked = face_multi.multi_face_step(nets, T(img), state, FX, FX, CX, CY, torch.tensor(False))
    assert len(calls) == 1  # only the tensor False ran the detector
    for a, b in zip(skipped[0], masked[0]):
        assert torch.equal(a, b)
    for key in skipped[1]:
        assert torch.equal(skipped[1][key], masked[1][key]), key
