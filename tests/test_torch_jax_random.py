"""``perception_tpu_torch.utils.jax_random`` (``jax.random`` in numpy)
against ``jax.random`` itself, and what the face fixture's trainer builds
from it: ``face_fixture.init_tiny(0)`` against the JAX package's
``init_tiny(jax.random.key(0))``, and the face batch draws, scenes and
evaluation scenes from JAX keys against the JAX functions'.

Keys, splits, folds, bits, ``uniform`` and ``bernoulli`` are bit-equal.
``normal`` and ``truncated_normal`` pass through XLA's float32 ``log1p``,
which the module emulates to within one ulp: over the draws below, 7 of
327,680 normal draws and 4 of 103,680 truncated-normal draws differ from
JAX's, none by more than 2 ulps; 2 of the face nets' 132,450 initial
weights differ, by 1 and 2 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from perception_tpu.models import face_data as jfd
from perception_tpu.models import face_fixture as jff
from perception_tpu_torch.convert import au_head_to_flax, face_detector_to_flax, facenet_to_flax
from perception_tpu_torch.models import face_data, face_fixture
from perception_tpu_torch.utils import jax_random as jr

from test_torch_train_data import jax_face_draws


def kd(k):
    return np.asarray(jax.random.key_data(k))


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 99, 2 ** 31 + 5])
def test_keys_splits_folds_bits_are_bit_equal(seed):
    k = jax.random.key(seed)
    assert np.array_equal(kd(k), jr.key(seed))
    assert np.array_equal(kd(jax.random.split(k, 7)), jr.split(jr.key(seed), 7))
    a, b = jax.random.split(k)
    ja, jb = jr.split(jr.key(seed))
    assert np.array_equal(kd(a), ja) and np.array_equal(kd(b), jb)
    for data in (0, 7, 99, 2 ** 32 - 1):
        assert np.array_equal(kd(jax.random.fold_in(k, data)), jr.fold_in(jr.key(seed), data))
    for shape in ((), (5,), (3, 4, 2)):
        assert np.array_equal(np.asarray(jax.random.bits(k, shape)), jr.random_bits(jr.key(seed), shape))


@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((3,), -0.5, 0.5), ((2,), -1.0, 1.0),
                                         ((4096,), -0.3, 0.3), ((), 0.45, 0.75), ((), 0.6, 1.0),
                                         ((64, 33), 0.0, 0.15)])
def test_uniform_and_bernoulli_are_bit_equal(shape, lo, hi):
    for seed in range(6):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=hi))
        assert np.array_equal(jr.uniform(jr.key(seed), shape, lo, hi), want)
        want = np.asarray(jax.random.bernoulli(jax.random.key(seed), 0.5, shape))
        assert np.array_equal(jr.bernoulli(jr.key(seed), 0.5, shape), want)


def test_normal_and_truncated_normal_within_two_ulps():
    unequal = {"normal": 0, "truncated": 0}
    for seed in range(20):
        d = ulps(jr.normal(jr.key(seed), (128, 128)), jax.random.normal(jax.random.key(seed), (128, 128)))
        assert d.max() <= 2
        unequal["normal"] += int((d > 0).sum())
        d = ulps(jr.truncated_normal(jr.key(seed), -2.0, 2.0, (3, 3, 24, 24)),
                 jax.random.truncated_normal(jax.random.key(seed), -2, 2, (3, 3, 24, 24)))
        assert d.max() <= 2
        unequal["truncated"] += int((d > 0).sum())
    # The counts the module docstring states (327,680 and 103,680 draws).
    assert unequal == {"normal": 7, "truncated": 4}, unequal


def test_log1p_emulation():
    x = jr.uniform(jr.key(3), (200_000,), np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    y = -(x * x)
    d = ulps(jr.log1p32(y), jax.jit(jnp.log1p)(y))
    small = np.abs(y) < 0.41421356
    assert d[small].max() == 0 and d.max() <= 1


def test_init_tiny_from_a_jax_seed_equals_jax_init():
    want = jax.tree.map(np.asarray, jff.init_tiny(jax.random.key(0)))
    nets = face_fixture.init_tiny(0, "cpu")
    got = {"landmark": facenet_to_flax(nets["landmark"]), "au": au_head_to_flax(nets["au"]),
           "det": face_detector_to_flax(nets["det"])}
    assert all(p.requires_grad for p in nets.parameters())
    unequal = total = 0
    for name in want:
        w, g = want[name]["params"], got[name]["params"]
        assert sorted(w) == sorted(g)
        for mod in w:
            for leaf in ("kernel", "bias"):
                assert w[mod][leaf].shape == g[mod][leaf].shape, (name, mod, leaf)
                d = ulps(g[mod][leaf], w[mod][leaf])
                assert d.max() <= 2, (name, mod, leaf)
                unequal += int((d > 0).sum())
                total += d.size
    assert total == 132_450 and unequal == 2, (total, unequal)


def test_face_batch_draws_from_key_match_jax():
    key, b, rot, noise = jax.random.key(1), 3, 0.5, 0.12
    bk = jax.random.split(key)[1]
    want = jax_face_draws(bk, b, (128, 128), 300.0, rot, noise)
    got = face_data.draw_face_batch_from_key(jr.split(jr.key(1))[1], b, rot_range=rot, pixel_noise=noise)
    assert np.array_equal(got.jitter, want.jitter) and np.array_equal(got.level, want.level)
    assert np.array_equal(got.scene.au02, want.scene.au02)
    assert ulps(got.noise, want.noise).max() <= 2 and ulps(got.pixel, want.pixel).max() <= 2
    np.testing.assert_allclose(got.scene.landmarks2d, want.scene.landmarks2d, atol=1e-4)
    np.testing.assert_allclose(got.scene.landmarks3d, want.scene.landmarks3d, atol=1e-6)
    np.testing.assert_allclose(got.scene.pose, want.scene.pose, atol=1e-6)
    # The batch the port's trainer makes from them, against the JAX tool's.
    want_batch = jfd.make_face_batch(bk, b, rot_range=rot, pixel_noise=noise)
    batch = face_data.make_face_batch(None, b, rot_range=rot, pixel_noise=noise, device="cpu", draws=got)
    np.testing.assert_allclose(batch["uv_crop"].numpy(), np.asarray(want_batch["uv_crop"]), atol=1e-3)
    np.testing.assert_allclose(batch["image"].numpy(), np.asarray(want_batch["image"]), atol=5e-2)


@pytest.mark.parametrize("rot_range", [0.30, 0.45])
def test_evaluation_scenes_from_key_match_jax(rot_range):
    key = jax.random.key(99)
    for i in range(3):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        want = jfd.sample_face(k1, jff.FIXTURE_HW, jff.FIXTURE_FX, jff.FIXTURE_FX, rot_range=rot_range)
        j1, j2 = jr.split(jr.fold_in(jr.key(99), i))
        got = face_data.sample_face_from_key(j1, face_fixture.FIXTURE_HW, face_fixture.FIXTURE_FX,
                                             face_fixture.FIXTURE_FX, rot_range=rot_range)
        np.testing.assert_allclose(got.landmarks2d, np.asarray(want.landmarks2d), atol=1e-4)
        assert float(got.au02) == float(want.au02)
        assert ulps(jr.normal(j2, face_fixture.FIXTURE_HW),
                    jax.random.normal(k2, jff.FIXTURE_HW)).max() <= 2


def test_evaluate_from_a_key_matches_jax_on_the_fixture():
    params = jax.tree.map(jnp.asarray, serialization.msgpack_restore(jff.FIXTURE_PATH.read_bytes()))
    want = jff.evaluate(params, jax.random.key(99), n_scenes=4)
    got = face_fixture.evaluate(face_fixture.load_fixture("cpu"), jr.key(99), n_scenes=4, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-3)
