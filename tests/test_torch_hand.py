"""The port's hand path against the JAX package on the CPU.

Same numpy inputs through both; the JAX side's weights from
``flax.serialization.msgpack_restore`` of ``handnet_tiny.msgpack``, the
port's from its own reader. Tolerances:

- ``render_hand`` on the same scene arrays within 5e-3 of 255 (XLA fuses
  the projection onto each stroke into FMAs: an ulp of a pixel coordinate
  below 96 is 7.6e-6, times the stroke edge's slope 1/1.5, times 255);
  ``hand_box`` equal; ``hand_roi_from_pose`` within 1e-5 px;
- the fixture net's heatmaps on the same crops within 1e-5; ``extract_hand``
  with the full-width net (flax's variable tree, LeCun-scaled normal
  weights, through ``handnet_from_flax``)
  the same as ``extract_hand_tiny`` below, scores within 1e-5 relative;
- ``extract_hand_tiny`` on four noisy scenes with their true boxes: the
  same landmark mask, landmarks within 1e-3 px, peak scores within 1e-5;
- ``evaluate``'s gate on ``chip_smoke.py``'s hand scenes (the first 8 of
  seed 11): mean landmark error under 3 px in at least 7 of 8, the JAX
  package's per-scene errors within 1e-3 px of the port's;
- the pose -> hand chain of the facade (``wrapper.py``'s ``hand_fn``:
  left and right boxes of the first 2 people of ``keep_top_n_people``,
  one batched crop and net call) on two fixture frames: boxes within
  1e-3 px, the same valid boxes and landmark masks, landmarks within
  1e-2 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from perception_tpu.models import hand as jhand
from perception_tpu.models import hand_data as jhd
from perception_tpu.models import hand_fixture as jhf
from perception_tpu.models import pose as jpose
from perception_tpu.models import pose_fixture as jpf
from perception_tpu.utils.keypoints import keep_top_n_people as j_keep_top_n
from perception_tpu_torch.convert import handnet_from_flax
from perception_tpu_torch.models import hand, hand_data, hand_fixture, pose_fixture
from perception_tpu_torch.utils.keypoints import keep_top_n_people

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


def jax_tree(path):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), serialization.msgpack_restore(path.read_bytes()))


@pytest.fixture(scope="module")
def jax_params():
    return jax_tree(jhf.FIXTURE_PATH)


@pytest.fixture(scope="module")
def net():
    return hand_fixture.load_fixture("cpu")


def noisy_scenes(seed, n):
    return hand_fixture.sample_scenes(np.random.default_rng(seed), n)


def test_render_hand_and_box_match_jax():
    for scene, _ in noisy_scenes(3, 3):
        want = jhd.render_hand(jhd.HandScene(jnp.asarray(scene.joints), jnp.asarray(scene.scale)),
                               hand_fixture.FIXTURE_HW)
        got = hand_data.render_hand(scene, hand_fixture.FIXTURE_HW)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-3)
        np.testing.assert_array_equal(hand_data.hand_box(scene.joints), np.asarray(jhd.hand_box(jnp.asarray(scene.joints))))


def test_hand_roi_from_pose_matches_jax():
    rng = np.random.default_rng(4)
    kp = (rng.random((5, 25, 3)) * [90, 90, 1]).astype(np.float32)
    kp[1, 3, 2] = 0.0      # elbow missing
    kp[2, 4, :2] = kp[2, 3, :2] + 0.5   # forearm shorter than 1 px
    for arm in (hand.LEFT_ARM, hand.RIGHT_ARM):
        box, ok = hand.hand_roi_from_pose(T(kp), arm=arm)
        for i in range(5):
            jbox, jok = jhand.hand_roi_from_pose(jnp.asarray(kp[i]), arm=arm)
            np.testing.assert_allclose(np_of(box[i]), np.asarray(jbox), rtol=0, atol=1e-5)
            assert bool(ok[i]) == bool(jok)
    assert not bool(hand.hand_roi_from_pose(T(kp[1]), arm=hand.RIGHT_ARM)[1])


def test_handnet_maps_match_jax(jax_params, net):
    crops = np.stack([hand_data.render_hand(s, (64, 64)) / 255.0 for s, _ in noisy_scenes(5, 2)]).astype(np.float32)
    want = jhf.tiny_handnet().apply(jax_params, jnp.asarray(crops[..., None]))
    with torch.no_grad():
        got = net(T(crops)[:, None])
    assert got.shape == (2, 21, 16, 16)
    np.testing.assert_allclose(np_of(got), np.asarray(want).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


def test_full_width_extract_hand_matches_jax():
    """``extract_hand`` with ``HandLandmarkNet()`` (width 64) and random
    weights in flax's variable tree, through ``handnet_from_flax``, on a
    gray frame."""
    scene, img = noisy_scenes(8, 1)[0]
    box = hand_data.hand_box(scene.joints)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(jhand.HandLandmarkNet().init, jax.random.key(1), jnp.zeros((1, 64, 64, 1)))
    params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32), shapes)
    full = hand.HandLandmarkNet()
    full.load_state_dict(handnet_from_flax(params, full, device="cpu"), assign=True)
    juv, jm, js = jhand.extract_hand(params, jnp.asarray(img), jnp.asarray(box))
    uv, m, s = hand.extract_hand(full, T(img), T(box))
    assert int(np.asarray(jm).sum()) > 0
    np.testing.assert_array_equal(np_of(m), np.asarray(jm))
    np.testing.assert_allclose(np_of(uv), np.asarray(juv), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_of(s), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_extract_hand_tiny_matches_jax(jax_params, net):
    for scene, img in noisy_scenes(6, 4):
        box = hand_data.hand_box(scene.joints)
        juv, jm, js = jhf.extract_hand_tiny(jax_params, jnp.asarray(img), jnp.asarray(box))
        uv, m, s = hand_fixture.extract_hand_tiny(net, T(img), T(box))
        np.testing.assert_array_equal(np_of(m), np.asarray(jm))
        np.testing.assert_allclose(np_of(uv), np.asarray(juv), rtol=0, atol=1e-3)
        np.testing.assert_allclose(np_of(s), np.asarray(js), rtol=0, atol=1e-5)


def test_hand_gate_on_the_smoke_scenes(jax_params, net):
    errs, jerrs = [], []
    for scene, img in noisy_scenes(chip_smoke.HAND_SEED, chip_smoke.HAND_SCENES):
        box = hand_data.hand_box(scene.joints)
        uv, m, _ = hand_fixture.extract_hand_tiny(net, T(img), T(box))
        juv, jm, _ = jhf.extract_hand_tiny(jax_params, jnp.asarray(img), jnp.asarray(box))
        errs.append(np.linalg.norm(np_of(uv) - scene.joints, axis=-1)[np_of(m)].mean())
        jerrs.append(np.linalg.norm(np.asarray(juv) - scene.joints, axis=-1)[np.asarray(jm)].mean())
    np.testing.assert_allclose(errs, jerrs, rtol=0, atol=1e-3)
    assert sum(e < 3.0 for e in errs) >= chip_smoke.HAND_SCENES - 1, errs
    rng = np.random.default_rng(chip_smoke.HAND_SEED)
    assert hand_fixture.evaluate(net, rng, chip_smoke.HAND_SCENES, device="cpu") == pytest.approx(np.mean(errs), abs=1e-6)


def jax_chain(pose_params, hand_params, image, n_people):
    """The facade's pose -> hand step as ``wrapper.py`` builds it."""
    ppl = jpose.extract_people(pose_params, jnp.asarray(image), "MPI_15", net_hw=(128, 128),
                               net=jpf.tiny_posenet(), peak_threshold=0.2, min_person_parts=5)
    kp, _, m = j_keep_top_n(ppl.keypoints, ppl.score, ppl.mask, n=n_people)
    gray = jnp.mean(jnp.asarray(image), axis=-1) * 255.0

    def rois(kp1):
        bl, okl = jhand.hand_roi_from_pose(kp1, arm=jhand.LEFT_ARM)
        br, okr = jhand.hand_roi_from_pose(kp1, arm=jhand.RIGHT_ARM)
        return jnp.stack([bl, br]), jnp.stack([okl, okr])

    boxes, ok = jax.vmap(rois)(kp[:n_people])
    uv, lm, _ = jax.vmap(lambda b: jhf.extract_hand_tiny(hand_params, gray, b))(boxes.reshape(-1, 4))
    valid = ok & m[:n_people, None]
    return boxes, valid, uv.reshape(n_people, 2, -1, 2), lm.reshape(n_people, 2, -1) & valid[..., None]


def test_pose_to_hand_chain_matches_jax(jax_params, net):
    pose_params = jax_tree(jpf.FIXTURE_PATH)
    pose_net = pose_fixture.load_fixture("cpu")
    _, images = pose_fixture.sample_scenes(np.random.default_rng(chip_smoke.POSE_SEED), 2)
    for image in images:
        want = jax_chain(pose_params, jax_params, image, 2)
        ppl = pose_fixture.extract_fixture_people(pose_net, T(image))
        kp, _, m = keep_top_n_people(ppl.keypoints, ppl.score, ppl.mask, 2)
        gray = T(image).mean(dim=-1) * 255.0
        got = hand_fixture.hands_from_pose(net, gray, kp, m, n_people=2)
        np.testing.assert_allclose(np_of(got["boxes"]), np.asarray(want[0]), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(np_of(got["box_valid"]), np.asarray(want[1]))
        assert np_of(got["box_valid"]).sum() >= 2
        np.testing.assert_array_equal(np_of(got["landmark_mask"]), np.asarray(want[3]))
        np.testing.assert_allclose(np_of(got["landmarks"]), np.asarray(want[2]), rtol=0, atol=1e-2)
