"""The port's face detectors (``models/face_detect.py``) and
``ops/image.bilinear_resize`` against the JAX package on the CPU.

Same numpy inputs through both. Tolerances:

- ``bilinear_resize`` (``jax.image.resize``, antialiased when it
  downsamples) of a [0, 255] image, down and up, gray and 3-channel:
  within 1e-3;
- ``_integral``: within two ulps of JAX's (rtol 2.4e-7; the port sums in
  float64 and rounds once, XLA's cumulative sum is a float32 tree);
  ``_level_scores`` within 5e-3 (scores of ~0.1-10; 1.9e-3 seen where a
  window's variance, mean2 - mean^2, cancels most of its digits), the
  flat windows' -1e9 equal;
- ``detect_faces`` on ``tests/test_face_detect.py``'s renders (one face,
  two scales and positions, two faces), a flat and a noise image, and a
  fixture face scene: the same detection mask, boxes within 5e-2 px
  (a peak's subpixel offset is a ratio of score differences, which carry
  the integral images' ulps; 1.6e-2 seen, at a level of scale 1.35^k),
  scores within 1e-3;
- ``FaceDetectorNet`` with the fixture's weights at 128x128 and at an odd
  97x129 (flax's SAME padding of a stride-2 conv is (0, 1) on an even
  size and (1, 1) on an odd one): maps within 1e-5;
- ``decode_detector_net`` on hand-made maps and on the net's maps: masks
  equal, boxes within 1e-4 px; ``_greedy_nms`` with tied scores keeps the
  lower index, as ``jnp.argmax``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

sys.path.insert(0, str(Path(__file__).parent))
import chip_smoke  # noqa: E402
from test_face_detect import render_face  # noqa: E402  (the JAX package's test scene)

from perception_tpu.models import face_detect as jfd  # noqa: E402
from perception_tpu.models import face_fixture as jff  # noqa: E402
from perception_tpu.ops.image import bilinear_resize as j_bilinear_resize  # noqa: E402
from perception_tpu_torch.models import face_detect, face_fixture  # noqa: E402
from perception_tpu_torch.ops.image import bilinear_resize  # noqa: E402

torch.set_num_threads(2)


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


@pytest.mark.parametrize("out_hw", [(89, 119), (61, 80), (200, 256)])
def test_bilinear_resize_matches_jax(out_hw):
    rng = np.random.default_rng(0)
    gray = (rng.random((120, 160)) * 255).astype(np.float32)
    rgb = (rng.random((120, 160, 3)) * 255).astype(np.float32)
    for img in (gray, rgb):
        got = np_of(bilinear_resize(T(img), out_hw))
        want = np.asarray(j_bilinear_resize(jnp.asarray(img), out_hw))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_integral_and_level_scores_match_jax():
    img, _ = render_face()
    got = np_of(face_detect._integral(T(img)))
    want = np.asarray(jax.jit(jfd._integral)(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    got = np_of(face_detect._level_scores(T(img)))
    want = np.asarray(jax.jit(jfd._level_scores)(jnp.asarray(img)))
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    live = want > -1e9
    assert live.sum() > 1000
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=5e-3)


def scenes():
    """(name, image): the JAX package's detector test renders, flat and
    noise images, and one fixture face scene."""
    one, _ = render_face()
    a, _ = render_face(cx=50, cy=40, size=28, seed=1)
    b, _ = render_face(cx=110, cy=70, size=56, seed=2)
    f1, _ = render_face(cx=45, cy=55, size=36, seed=3)
    f2, _ = render_face(cx=120, cy=60, size=36, seed=4)
    noise = (np.random.RandomState(0).randn(120, 160) * 30 + 128).astype(np.float32)
    _, fixture = chip_smoke.face_scenes(n=1)[0]
    return [("one", one), ("small", a), ("large", b), ("two", np.maximum(f1, f2)),
            ("flat", np.full((120, 160), 128.0, np.float32)), ("noise", noise), ("fixture", fixture)]


@pytest.mark.parametrize("name,img", scenes(), ids=[n for n, _ in scenes()])
def test_detect_faces_matches_jax(name, img):
    got = face_detect.detect_faces(T(img))
    want = jfd.detect_faces(jnp.asarray(img))
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    m = np.asarray(want.mask)
    assert (m.any() if name not in ("flat", "noise") else True)
    assert not (name == "flat" and m.any())
    np.testing.assert_allclose(np_of(got.boxes)[m], np.asarray(want.boxes)[m], rtol=0, atol=5e-2)
    np.testing.assert_allclose(np_of(got.scores)[m], np.asarray(want.scores)[m], rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw", [(128, 128), (97, 129)])
def test_detector_net_matches_jax(jax_params, nets, hw):
    x = np.random.default_rng(1).random(hw, dtype=np.float32)
    jheat, jsize = jff.tiny_detector().apply(jax_params["det"], jnp.asarray(x[..., None]))
    with torch.no_grad():
        heat, size = nets["det"](T(x)[None, None])
    assert heat.shape == (1,) + jheat.shape == (1, -(-hw[0] // 4), -(-hw[1] // 4))
    np.testing.assert_allclose(np_of(heat[0]), np.asarray(jheat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_of(size[0]), np.asarray(jsize), rtol=0, atol=1e-5)


def test_decode_detector_net_matches_jax(jax_params, nets):
    heat = np.full((24, 24), -5.0, np.float32)
    heat[12, 10], heat[3, 20] = 3.0, 1.0
    size = np.full((24, 24), np.log(8.0), np.float32)
    size[3, 20] = np.log(4.0)
    cases = [(heat, size, 0.0, 4)]
    _, img = chip_smoke.face_scenes(n=1)[0]
    h, s = jff.tiny_detector().apply(jax_params["det"], jnp.asarray(img[..., None] / 255.0))
    cases.append((np.asarray(h), np.asarray(s), 0.3, 4))
    for heat, size, thr, k in cases:
        got = face_detect.decode_detector_net(T(heat), T(size), threshold=thr, max_faces=k)
        want = jfd.decode_detector_net(jnp.asarray(heat), jnp.asarray(size), threshold=thr, max_faces=k)
        np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
        np.testing.assert_allclose(np_of(got.boxes), np.asarray(want.boxes), rtol=0, atol=1e-4)
        assert bool(got.mask[0])
    np.testing.assert_allclose(np_of(face_detect.decode_detector_net(T(cases[0][0]), T(cases[0][1])).boxes[0]),
                               [24.0, 32.0, 56.0, 64.0], atol=0.5)
    got = face_fixture.detect_with_net(nets["det"], T(img))
    want = jff.detect_with_net(jax_params["det"], jnp.asarray(img))
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_allclose(np_of(got.boxes), np.asarray(want.boxes), rtol=0, atol=1e-3)


def test_greedy_nms_ties_keep_the_lower_index():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [30, 30, 40, 40], [31, 30, 41, 40], [60, 0, 70, 10]],
                     np.float32)
    scores = np.array([2.0, 2.0, 1.0, 1.0, 1.0], np.float32)
    valid = np.array([True, True, True, True, False])
    got = face_detect._greedy_nms(T(boxes), T(scores), T(valid), 0.3, 4)
    want = jfd._greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.3, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))
    np.testing.assert_array_equal(np_of(got.boxes)[:2], boxes[[0, 2]])
    assert np_of(got.mask).tolist() == [True, True, False, False]
