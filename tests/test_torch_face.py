"""The port's face analysis (``models/face.py``, ``models/face_data.py``,
``models/face_fixture.py``) against the JAX package on the CPU.

Same numpy inputs through both; the JAX side's weights from
``flax.serialization.msgpack_restore`` of ``facenet_tiny.msgpack``, the
port's from its own reader. Tolerances:

- constants, the canonical face model and ``crop_box_from_landmarks``
  equal; ``face_roi_from_pose`` within 1e-4 px (an ulp at 300 px is
  3e-5), ``iou`` within 1e-6, the dedup mask equal;
- the fixture's landmark net on the same crops, and a width-16 net with
  random flax weights through ``facenet_from_flax``, within 1e-5; the AU
  head within 1e-5, ``normalize_landmarks`` within 1e-6 (also with no
  valid landmark, where it divides by its 1e-6 floor);
- ``head_pose_pnp`` (batched over faces here, ``vmap``-free; jitted
  there): poses within 1e-4 (10 GN steps amplify ulps), within 1e-3 on
  four noisy points (an ill-conditioned system: 2e-4 seen), errors
  within 1e-4 px, NaN where JAX has NaN; ``gaze_from_landmarks`` within 1e-5;
- the scene geometry on the same draws within 1e-4 px; ``render_face`` and
  ``render_faces`` (no noise) within 5e-3 of 255 (XLA fuses the stroke
  distances into FMAs);
- the single-face chain of ``chip_smoke.face_chain`` on
  ``chip_smoke.face_scenes()`` (the card's scenes) against the JAX
  package's ``tests/test_face_e2e.py`` pipeline: boxes and landmarks
  within 1e-3 px, the same masks, poses within 1e-4, AU intensities and
  gaze within 1e-4; every gate of that test holds on the port's answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from perception_tpu.geometry import se3 as jse3
from perception_tpu.models import face as jface
from perception_tpu.models import face_data as jfd
from perception_tpu.models import face_fixture as jff
from perception_tpu.models.hand import crop_image as j_crop_image
from perception_tpu_torch.convert import facenet_from_flax
from perception_tpu_torch.models import face, face_data, face_fixture

torch.set_num_threads(2)
FX, FY, CX, CY = 616.8, 616.6, 321.8, 239.9


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                        serialization.msgpack_restore(jff.FIXTURE_PATH.read_bytes()))


@pytest.fixture(scope="module")
def nets():
    return face_fixture.load_fixture("cpu")


def test_constants_and_canonical_model_match_jax():
    assert face.AU_NAMES == jface.AU_NAMES and face.NUM_FACE_LANDMARKS == jface.NUM_FACE_LANDMARKS
    np.testing.assert_array_equal(face.PNP_LANDMARK_IDS, jface.PNP_LANDMARK_IDS)
    np.testing.assert_array_equal(face.PNP_MODEL_POINTS, jface.PNP_MODEL_POINTS)
    np.testing.assert_array_equal(face.RIGHT_EYE_RING, jface.RIGHT_EYE_RING)
    np.testing.assert_array_equal(face.LEFT_EYE_RING, jface.LEFT_EYE_RING)
    assert (face.RIGHT_PUPIL, face.LEFT_PUPIL) == (jface.RIGHT_PUPIL, jface.LEFT_PUPIL)
    np.testing.assert_array_equal(face_data.CANONICAL_FACE_3D, jfd.CANONICAL_FACE_3D)
    np.testing.assert_array_equal(face_data.BROW_IDS, jfd.BROW_IDS)
    for au02 in (0.0, 0.7, 1.0):
        np.testing.assert_array_equal(face_data.deformed_model(au02), np.asarray(jfd.deformed_model(jnp.float32(au02))))
    assert (face_fixture.FIXTURE_HW, face_fixture.FIXTURE_CROP, face_fixture.FIXTURE_FX) == (
        jff.FIXTURE_HW, jff.FIXTURE_CROP, jff.FIXTURE_FX)


def test_face_roi_iou_and_dedup_match_jax():
    rng = np.random.default_rng(0)
    kp = (rng.random((4, 25, 3)) * [300, 200, 1]).astype(np.float32)
    kp[1, [15, 16, 17], 2] = 0.0   # some face parts missing
    kp[2, [0, 15, 16, 17, 18], 2] = 0.0  # none: the box falls back to half size 8 at (0, 0)
    got = np_of(face.face_roi_from_pose(T(kp)))
    for i in range(4):
        np.testing.assert_allclose(got[i], np.asarray(jface.face_roi_from_pose(jnp.asarray(kp[i]))), rtol=0, atol=1e-4)

    a = (rng.random((6, 4)) * 50).astype(np.float32)
    a[:, 2:] += a[:, :2] + 5
    b = (rng.random((5, 4)) * 50).astype(np.float32)
    b[:, 2:] += b[:, :2] + 5
    b[0] = a[0]
    np.testing.assert_allclose(np_of(face.iou(T(a)[:, None], T(b)[None])),
                               np.asarray(jface.iou(jnp.asarray(a)[:, None], jnp.asarray(b)[None])), rtol=0, atol=1e-6)
    tm, dm = np.array([True, False, True, True, False, True]), np.array([True, True, False, True, True])
    for thr in (0.1, 0.5):
        want = jface.non_overlapping_detections(jnp.asarray(a), jnp.asarray(tm), jnp.asarray(b), jnp.asarray(dm), thr)
        got = face.non_overlapping_detections(T(a), T(tm), T(b), T(dm), thr)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_landmark_nets_match_jax(jax_params, nets):
    """The fixture's width-24 net on two face crops, and a width-16 net
    with random flax weights (LeCun-scaled normal) on a 64x64 input."""
    scenes = chip_smoke.face_scenes(n=2)
    crops = np.stack([face_data.render_face(s, (96, 96)) / 255.0 for s, _ in scenes]).astype(np.float32)
    want = jff.tiny_facenet().apply(jax_params["landmark"], jnp.asarray(crops[..., None]))
    with torch.no_grad():
        got = nets["landmark"](T(crops)[:, None])
    assert got.shape == (2, 70, 24, 24)
    np.testing.assert_allclose(np_of(got), np.asarray(want).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)

    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(jface.FaceLandmarkNet(width=16).init, jax.random.key(1), jnp.zeros((1, 64, 64, 1)))
    params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32), shapes)
    net = face.FaceLandmarkNet(width=16)
    net.load_state_dict(facenet_from_flax(params, net, device="cpu"), assign=True)
    x = rng.random((1, 64, 64, 1), dtype=np.float32)
    with torch.no_grad():
        got = net(T(x).permute(0, 3, 1, 2))
    want = jface.FaceLandmarkNet(width=16).apply(params, jnp.asarray(x))
    np.testing.assert_allclose(np_of(got), np.asarray(want).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


def pnp_cases():
    """(landmarks (B, 70, 2), masks (B, 70)): the JAX test's exact
    projection, the same with noise and a part of the landmarks masked,
    no valid landmark (both branches tie at error 0: the first wins), and
    a NaN landmark (both branches NaN)."""
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.05, -0.03, 0.7, 0.1, 0.2, -0.1], jnp.float32)))
    pc = face.PNP_MODEL_POINTS @ T_true[:3, :3].T + T_true[:3, 3]
    uv6 = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    rng = np.random.default_rng(2)
    lms = (rng.random((4, 70, 2)) * 400).astype(np.float32)
    mask = np.ones((4, 70), bool)
    lms[0, face.PNP_LANDMARK_IDS] = uv6
    lms[1, face.PNP_LANDMARK_IDS] = uv6 + rng.normal(0, 1.5, uv6.shape)
    mask[1, face.PNP_LANDMARK_IDS[:2]] = False
    mask[2] = False
    lms[3, face.PNP_LANDMARK_IDS[3]] = np.nan
    return lms, mask


def test_head_pose_pnp_and_gaze_match_jax():
    lms, mask = pnp_cases()
    Tp, ep = face.head_pose_pnp(T(lms), T(mask), FX, FY, CX, CY)
    for i, tol in enumerate((1e-4, 1e-3, 1e-4, 1e-4)):
        jT, je = jface.head_pose_pnp(jnp.asarray(lms[i]), jnp.asarray(mask[i]), FX, FY, CX, CY)
        np.testing.assert_allclose(np_of(Tp[i]), np.asarray(jT), rtol=0, atol=tol, equal_nan=True)
        np.testing.assert_allclose(float(ep[i]), float(je), rtol=0, atol=1e-4, equal_nan=True)
    assert float(ep[0]) < 0.5 and not np.isfinite(np_of(Tp[3])).any()
    np.testing.assert_array_equal(np_of(Tp[2]), np.asarray(jface.head_pose_pnp(
        jnp.asarray(lms[2]), jnp.asarray(mask[2]), FX, FY, CX, CY)[0]))  # the tie: identity's branch

    gr, gl = face.gaze_from_landmarks(T(lms[:2]), Tp[:2], FX, FY, CX, CY)
    for i in range(2):
        jr, jl = jface.gaze_from_landmarks(jnp.asarray(lms[i]), jnp.asarray(np_of(Tp[i])), FX, FY, CX, CY)
        np.testing.assert_allclose(np_of(gr[i]), np.asarray(jr), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_of(gl[i]), np.asarray(jl), rtol=0, atol=1e-5)


def test_au_head_normalize_and_gate_match_jax(jax_params, nets):
    rng = np.random.default_rng(3)
    lms = (rng.random((3, 70, 2)) * 100).astype(np.float32)
    mask = rng.random((3, 70)) > 0.2
    mask[2] = False
    norm = face.normalize_landmarks(T(lms), T(mask))
    with torch.no_grad():
        inten, pres = nets["au"](norm)
    for i in range(3):
        jn = jface.normalize_landmarks(jnp.asarray(lms[i]), jnp.asarray(mask[i]))
        np.testing.assert_allclose(np_of(norm[i]), np.asarray(jn), rtol=0, atol=1e-6)
        if i == 2:
            continue  # no valid landmark: d / 1e-6, AU logits of ~1e8
        ji, jp = jff.tiny_au_head().apply(jax_params["au"], jn)
        np.testing.assert_allclose(np_of(inten[i]), np.asarray(ji), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_of(pres[i]), np.asarray(jp), rtol=0, atol=1e-5)

    i = np.zeros((3, len(face.AU_NAMES)), np.float32)
    au02 = face.AU_NAMES.index("AU02")
    i[0, au02], i[1, au02], i[2, au02], i[2, 0] = 2.5, 2.0, 0.1, 5.0
    got = np_of(face.au_gated_pose_mask(T(i)))
    assert got.tolist() == [True, False, False]
    np.testing.assert_array_equal(got, np.asarray(jface.au_gated_pose_mask(jnp.asarray(i))))


def jax_scene(rot, txy, z, au02, hw, fx):
    """The JAX package's sample_face body on given draws."""
    R = jse3.so3_exp(jnp.asarray(rot, jnp.float32)) @ jse3.so3_exp(jnp.asarray([0.0, jnp.pi, 0.0]))
    Tm = jse3.make_T(R, jnp.asarray([txy[0], txy[1], z], jnp.float32))
    pc = jse3.transform_points(Tm, jfd.deformed_model(jnp.float32(au02)))
    zc = jnp.maximum(pc[:, 2], 1e-6)
    uv = jnp.stack([fx * pc[:, 0] / zc + hw[1] / 2.0, fx * pc[:, 1] / zc + hw[0] / 2.0], axis=-1)
    return jfd.FaceScene(pose=Tm, landmarks2d=uv, landmarks3d=pc, au02=jnp.float32(au02))


def test_scenes_and_renders_match_jax():
    hw, fx = (128, 128), 300.0
    draws = [((0.1, -0.2, 0.05), (0.02, -0.01), 0.6, 0.8), ((-0.25, 0.1, 0.2), (-0.05, 0.03), 0.5, 0.05)]
    scenes = []
    for rot, txy, z, au02 in draws:
        got = face_data.scene_from_pose(np.float32(rot), txy, z, au02, hw, fx, fx)
        want = jax_scene(rot, txy, z, au02, hw, fx)
        np.testing.assert_allclose(got.pose, np.asarray(want.pose), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.landmarks3d, np.asarray(want.landmarks3d), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.landmarks2d, np.asarray(want.landmarks2d), rtol=0, atol=1e-4)
        np.testing.assert_allclose(face_data.render_face(got, hw), np.asarray(jfd.render_face(want, hw)),
                                   rtol=0, atol=5e-3)
        np.testing.assert_array_equal(face_data.crop_box_from_landmarks(got.landmarks2d),
                                      np.asarray(jfd.crop_box_from_landmarks(jnp.asarray(got.landmarks2d))))
        scenes.append(got)
    stacked = face_data.stack_scenes(scenes)
    jstacked = jax.tree.map(jnp.asarray, jfd.FaceScene(*stacked))
    np.testing.assert_allclose(face_data.render_faces(stacked, hw), np.asarray(jfd.render_faces(jstacked, hw)),
                               rtol=0, atol=5e-3)
    noise = np.random.default_rng(4).standard_normal(hw).astype(np.float32)
    rng_img = face_data.render_face(scenes[0], hw, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(rng_img, face_data.render_face(scenes[0], hw, noise=noise))


def jax_chain(params, img):
    """``tests/test_face_e2e.py``'s ``run_pipeline`` at the fixture setting."""
    hw, fx = jff.FIXTURE_HW, jff.FIXTURE_FX
    det = jff.detect_with_net(params["det"], img)
    box = det.boxes[0]
    patch = j_crop_image(img, box, jff.FIXTURE_CROP) / 255.0
    uv, m, _ = jff.landmarks_from_crop(params["landmark"], patch, box)
    Tm, _ = jface.head_pose_pnp(uv, m, fx, fx, hw[1] / 2.0, hw[0] / 2.0)
    gr, gl = jface.gaze_from_landmarks(uv, Tm, fx, fx, hw[1] / 2.0, hw[0] / 2.0)
    inten, _ = jff.tiny_au_head().apply(params["au"], jface.normalize_landmarks(uv, m))
    return {"box": box, "landmarks": uv, "landmark_mask": m, "head_pose": Tm, "gaze": jnp.stack([gr, gl]),
            "au_intensities": inten}


def test_single_face_chain_matches_jax_on_the_smoke_scenes(jax_params, nets):
    hw, fx = face_fixture.FIXTURE_HW, face_fixture.FIXTURE_FX
    rows = []
    for scene, img in chip_smoke.face_scenes():
        got = chip_smoke.face_chain(nets, T(img), fx, hw[1] / 2.0, hw[0] / 2.0)
        want = jax_chain(jax_params, jnp.asarray(img))
        assert bool(got["found"])
        np.testing.assert_array_equal(np_of(got["landmark_mask"]), np.asarray(want["landmark_mask"]))
        for key, tol in (("box", 1e-3), ("landmarks", 1e-3), ("head_pose", 1e-4), ("gaze", 1e-4),
                         ("au_intensities", 1e-4)):
            np.testing.assert_allclose(np_of(got[key]), np.asarray(want[key]), rtol=0, atol=tol, err_msg=key)
        rows.append(chip_smoke.face_gates(scene, got))
    ious, errs, pose_ok, gaze_ok, gate_ok = zip(*rows)
    n = chip_smoke.FACE_SCENES
    assert min(ious) > 0.5 and np.mean(errs) < 4.0 and all(gaze_ok), rows
    assert sum(pose_ok) >= n - 1 and sum(gate_ok) >= n - 1, rows


def test_evaluate_on_fresh_scenes(nets):
    err, sep, mean_iou = face_fixture.evaluate(nets, np.random.default_rng(5), n_scenes=6, device="cpu")
    assert err < 4.0 and sep > 0.0 and mean_iou > 0.5, (err, sep, mean_iou)
