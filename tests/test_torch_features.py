"""The port's FAST / BRIEF / Hamming matching against the JAX package.

Images: ``blobs_image`` and ``checkerboard`` of ``test_features.py`` and
one gray of the textured room of ``test_slam_system.py``. Tolerances, as
measured on those images:

- ``fast_detect``: uv, mask and order equal (the top-K is a stable sort,
  as XLA's ``top_k`` orders ties); scores equal (held to rtol 1e-6);
  angles within 2.2e-5 (held to atol 5e-5): XLA adds the 225 moment terms
  of the orientation patch in order, ``torch.sum`` pairwise.
- ``box_blur``: equal bit for bit to ``jax.jit(box_blur)`` (XLA multiplies
  the window sum by the reciprocal of its constant count).
- ``brief_describe``: 0 of 256 bits differ on every keypoint measured;
  held to at most 2 differing bits per descriptor.
- ``match_descriptors`` on the same (JAX) descriptors: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.ops import features as jf
from perception_tpu_torch.ops import features as tf
from test_features import blobs_image, checkerboard
from test_slam_system import cam, render_textured_room

torch.set_num_threads(2)


def room_gray():
    return render_textured_room(cam(), np.eye(4))[0]


IMAGES = {  # name -> (image, threshold, max_keypoints)
    "blobs": (blobs_image, 30.0, 64),
    "room": (room_gray, 15.0, 128),
    "checkerboard": (checkerboard, 30.0, 64),
}


def detect_both(name, subpixel=False):
    make, thr, k = IMAGES[name]
    img = make()
    jk = jf.fast_detect(jnp.asarray(img), threshold=thr, max_keypoints=k, subpixel=subpixel)
    tk = tf.fast_detect(torch.from_numpy(img), threshold=thr, max_keypoints=k, subpixel=subpixel)
    return img, jk, tk


@pytest.mark.parametrize("name,subpixel", [("blobs", False), ("room", False), ("checkerboard", False),
                                           ("blobs", True)])
def test_fast_detect_matches_jax(name, subpixel):
    _, jk, tk = detect_both(name, subpixel)
    np.testing.assert_array_equal(tk.uv.numpy(), np.asarray(jk.uv))
    np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
    np.testing.assert_allclose(tk.score.numpy(), np.asarray(jk.score), rtol=1e-6)
    np.testing.assert_allclose(tk.angle.numpy(), np.asarray(jk.angle), atol=5e-5, rtol=0)
    assert (int(tk.mask.sum()) == 0) == (name == "checkerboard")


@pytest.mark.parametrize("name", ["blobs", "room"])
def test_box_blur_matches_jitted_jax_bit_for_bit(name):
    img = IMAGES[name][0]()
    want = np.asarray(jax.jit(jf.box_blur)(jnp.asarray(img)))
    np.testing.assert_array_equal(tf.box_blur(torch.from_numpy(img)).numpy(), want)


def differing_bits(a_int32, b_uint32):
    x = np.bitwise_xor(np.asarray(a_int32).view(np.uint32), np.asarray(b_uint32))
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


@pytest.mark.parametrize("name", ["blobs", "room"])
def test_brief_describe_matches_jax(name):
    img, jk, tk = detect_both(name)
    jd = jf.brief_describe(jnp.asarray(img), jk)
    td = tf.brief_describe(torch.from_numpy(img), tk)
    assert td.shape == jd.shape and td.dtype == torch.int32
    assert differing_bits(td.numpy(), jd).max() <= 2


def test_popcount_matches_lax_population_count():
    words = np.random.RandomState(0).randint(0, 2**32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    words[0] = [0, 0xFFFFFFFF, 0x80000000, 1, 0x7FFFFFFF, 0xAAAAAAAA, 0x55555555, 0xF0F0F0F0]
    want = np.asarray(jax.lax.population_count(jnp.asarray(words))).astype(np.int32)
    np.testing.assert_array_equal(tf.popcount32(torch.from_numpy(words.view(np.int32))).numpy(), want)


def jax_descriptors(img, thr, k):
    kps = jf.fast_detect(jnp.asarray(img), threshold=thr, max_keypoints=k)
    return jf.brief_describe(jnp.asarray(img), kps), kps.mask


def test_match_descriptors_matches_jax_on_jax_descriptors():
    base = blobs_image(seed=3)
    da, ma = jax_descriptors(base, 30.0, 128)
    db, mb = jax_descriptors(np.roll(base, (7, 11), (0, 1)), 30.0, 128)
    want = jf.match_descriptors(da, ma, db, mb, max_matches=128)
    got = tf.match_descriptors(*(torch.from_numpy(np.array(x).view(np.int32) if x.dtype == jnp.uint32 else np.array(x))
                                 for x in (da, ma, db, mb)), max_matches=128)
    assert int(got.mask.sum()) >= 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_match_equals_one_set_at_a_time():
    img = room_gray()
    d, m = jax_descriptors(img, 15.0, 128)
    d = torch.from_numpy(np.array(d).view(np.int32))
    m = torch.from_numpy(np.array(m))
    others = torch.stack([d, torch.roll(d, 5, 0), d ^ 1]), torch.stack([m, torch.roll(m, 5, 0), m])
    batched = tf.match_descriptors(d.expand(3, -1, -1), m.expand(3, -1), *others, max_matches=128)
    for k in range(3):
        one = tf.match_descriptors(d, m, others[0][k], others[1][k], max_matches=128)
        for b, o in zip(batched, one):
            assert torch.equal(b[k], o)
