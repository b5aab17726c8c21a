"""The port's PoseNet and ``extract_people`` against the JAX package on the CPU.

Same numpy inputs through both. The JAX side's weights come from
``flax.serialization.msgpack_restore`` of the fixture file (as
``load_fixture`` gives them, float16 -> float32), the port's from its own
reader through ``convert.posenet_from_flax``. Tolerances:

- maps of the trained fixture at 128x128: within 1e-5 (float32
  convolutions summed in another order);
- a small random net (flax's variable tree, LeCun-scaled normal weights
  and biases, 3 stages) at a non-square 64x96 input through
  ``posenet_from_flax``: maps within 1e-5;
- ``extract_people`` on the fixture, two rendered scenes, one frame at a
  time and as a batch of two, and at two scales: the same people, part
  counts and peaks, keypoints within 1e-3 px, scores within 1e-4; a 160x200
  frame (downsampled to 128x128 with antialiasing) the same way;
- ``render_people`` on the same scene arrays within 3e-5 (XLA fuses the
  projection onto each limb into FMAs: an ulp of a pixel coordinate below
  128 is 7.6e-6, times the capsule edge's slope 1/1.5);
- ``pck_on_images`` of both packages on the port's scenes (the first 8 of
  seed 1234): equal PCK and recall, and the JAX package's values are the
  ones ``chip_smoke.py`` holds the card to (``POSE_JAX_PCK``);
  ``evaluate_pck`` draws the same scenes and gives the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from perception_tpu.models import pose as jpose
from perception_tpu.models import pose_data as jpd
from perception_tpu.models import pose_fixture as jpf
from perception_tpu_torch.convert import posenet_from_flax
from perception_tpu_torch.models import pose, pose_data, pose_fixture

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                        serialization.msgpack_restore(jpf.FIXTURE_PATH.read_bytes()))


@pytest.fixture(scope="module")
def net():
    return pose_fixture.load_fixture("cpu")


@pytest.fixture(scope="module")
def scenes():
    return pose_fixture.sample_scenes(np.random.default_rng(7), 2)


def test_fixture_maps_match_jax(jax_params, net, scenes):
    _, images = scenes
    jp, jh = jpf.tiny_posenet().apply(jax_params, jnp.asarray(images))
    with torch.no_grad():
        tp, th = net(T(images).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(np_of(tp), np.asarray(jp).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_of(th), np.asarray(jh).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


def test_random_net_non_square_matches_jax():
    kwargs = dict(num_parts=25, num_limbs=24, num_stages=3, backbone_widths=(8, 12, 16), stage_width=16,
                  stage_depth=2)
    jnet = jpose.PoseNet(**kwargs)
    rng = np.random.default_rng(4)
    x = rng.random((2, 64, 96, 3), dtype=np.float32)
    # flax's variable tree (names and shapes from eval_shape; ``init``
    # itself compiles for ~20 s), filled with LeCun-scaled normals.
    shapes = jax.eval_shape(jnet.init, jax.random.key(3), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32), shapes)
    net = pose.PoseNet(**kwargs)
    net.load_state_dict(posenet_from_flax(params, net, device="cpu"), assign=True)
    jp, jh = jnet.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tp, th = net(T(x).permute(0, 3, 1, 2).contiguous())
    assert tp.shape == (2, 48, 8, 12) and th.shape == (2, 26, 8, 12)
    np.testing.assert_allclose(np_of(tp), np.asarray(jp).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_of(th), np.asarray(jh).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


def test_init_posenet_draws_flax_statistics():
    g = torch.Generator().manual_seed(0)
    net = pose.init_posenet(g, "BODY_25", device="cpu")
    assert net.stages[-1].paf.out_channels == 48 and net.stages[-1].hm.out_channels == 26
    w = net.stages[1].convs[0].weight  # fan-in 9 * (128 + 48 + 26)
    std = (1.0 / (9 * 202)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    again = pose.init_posenet(torch.Generator().manual_seed(0), "BODY_25", device="cpu")
    assert torch.equal(again.stages[1].convs[0].weight, w)


def assert_same_people(got, want, kp_atol=1e-3, score_atol=1e-4):
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(np_of(got.num_parts), np.asarray(want.num_parts))
    kg, kw = np_of(got.keypoints), np.asarray(want.keypoints)
    np.testing.assert_array_equal(kg[..., 2] > 0, kw[..., 2] > 0)
    np.testing.assert_allclose(kg, kw, rtol=0, atol=kp_atol)
    np.testing.assert_allclose(np_of(got.score), np.asarray(want.score), rtol=0, atol=score_atol)


def jax_people(params, image, **kwargs):
    return jpose.extract_people(params, jnp.asarray(image), topology="MPI_15", net_hw=(128, 128),
                                net=jpf.tiny_posenet(), peak_threshold=0.2, min_person_parts=5, **kwargs)


@pytest.mark.parametrize("scales", [(1.0,), (1.0, 0.75)])
def test_extract_people_matches_jax_single_and_batched(jax_params, net, scenes, scales):
    _, images = scenes
    batch = pose.extract_people(net, T(images), "MPI_15", scales=scales, net_hw=(128, 128),
                                **pose_fixture.FIXTURE_DECODE)
    for f in range(2):
        want = jax_people(jax_params, images[f], scales=scales)
        assert np.asarray(want.mask).sum() >= 1
        one = pose.extract_people(net, T(images[f]), "MPI_15", scales=scales, net_hw=(128, 128),
                                  **pose_fixture.FIXTURE_DECODE)
        assert_same_people(one, want)
        # The batch's convolutions sum in another order than one frame's.
        assert_same_people(pose.People(*(x[f] for x in batch)), want)


def test_extract_people_downsamples_like_jax(jax_params, net):
    scene = pose_data.sample_skeletons(np.random.default_rng(9), (160, 200))
    image = pose_data.render_people(scene, (160, 200))
    want = jax_people(jax_params, image)
    got = pose_fixture.extract_fixture_people(net, T(image))
    assert np.asarray(want.mask).sum() >= 1
    assert_same_people(got, want)


def test_render_people_matches_jax(scenes):
    sk, images = scenes
    for f in range(2):
        want = jpd.render_people(jpd.SkeletonScene(jnp.asarray(sk.joints[f]), jnp.asarray(sk.valid[f])), (128, 128))
        np.testing.assert_allclose(images[f], np.asarray(want), rtol=0, atol=3e-5)


def test_pck_matches_jax_on_the_smoke_scenes(jax_params, net):
    sk, images = pose_fixture.sample_scenes(np.random.default_rng(chip_smoke.POSE_SEED), chip_smoke.POSE_SCENES)
    want = jpf.pck_on_images(jax_params, images, jpd.SkeletonScene(jnp.asarray(sk.joints), jnp.asarray(sk.valid)))
    got = pose_fixture.pck_on_images(net, images, sk, device="cpu")
    assert got == want
    assert want == chip_smoke.POSE_JAX_PCK
    assert pose_fixture.evaluate_pck(net, np.random.default_rng(chip_smoke.POSE_SEED), chip_smoke.POSE_SCENES,
                                     device="cpu") == want
