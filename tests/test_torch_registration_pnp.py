"""The port's rigid RANSAC and PnP against the JAX package.

The JAX package draws hypotheses with ``jax.random.categorical`` over the
mask; the port takes the same draws as ``indices`` (drawn here with
``jax.random.categorical`` and the JAX call's key), so both score the same
hypotheses. Tolerances, as measured:

- ``ransac_rigid``: transform within 4.2e-7 (held to atol 1e-5), inliers
  and their count equal, validity equal;
- ``pnp_gn``: transform within 8.2e-8 (held to atol 1e-4), mean pixel
  error rtol 1e-6 (held to 1e-4), gated count equal;
- ``pnp_ransac``: transform within 7.7e-8 (held to atol 1e-4), inliers
  and validity equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops import pnp as jp
from perception_tpu.ops import registration as jr
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import pnp as tp
from perception_tpu_torch.ops import registration as tr
from test_pnp import CX, CY, FX, FY, make_problem

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def categorical(key, mask, shape):
    return t(jax.random.categorical(key, jnp.where(jnp.asarray(mask), 0.0, -jnp.inf), shape=shape))


def rigid_case(seed, outliers=30):
    rng = np.random.RandomState(seed)
    src = rng.randn(100, 3).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.1, 0.2, -0.1], jnp.float32)))
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:outliers] += (rng.randn(outliers, 3) * 2.0).astype(np.float32)
    return src, dst, rng.rand(100) > 0.1, T


@pytest.mark.parametrize("seed,masked", [(0, False), (1, False), (2, True)])
def test_ransac_rigid_matches_jax_with_the_same_triplets(seed, masked):
    src, dst, mask, _ = rigid_case(seed)
    if masked:
        mask[:] = False
    key = jax.random.key(seed)
    want = jr.ransac_rigid(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), key,
                           threshold=0.02, num_hypotheses=128)
    got = tr.ransac_rigid(t(src), t(dst), t(mask), threshold=0.02, num_hypotheses=128,
                          indices=categorical(key, mask, (128, 3)))
    assert bool(got.valid) == bool(want.valid) == (not masked)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    if not masked:
        np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5, rtol=0)


def test_ransac_rigid_draws_from_a_generator():
    src, dst, mask, T = rigid_case(0)
    fit = tr.ransac_rigid(t(src), t(dst), t(mask), torch.Generator().manual_seed(0), threshold=0.02)
    assert bool(fit.valid) and int(fit.num_inliers) >= 55
    np.testing.assert_allclose(fit.transform.numpy(), T, atol=5e-3)
    with pytest.raises(ValueError):
        tr.ransac_rigid(t(src), t(dst), t(mask))


def pnp_case(seed):
    pts, uv, _ = make_problem(jax.random.key(seed))
    uv = np.array(uv)
    uv[:20] += 30.0  # outliers
    mask = np.ones(len(pts), bool)
    mask[5] = False
    return np.array(pts), uv, mask


@pytest.mark.parametrize("seed,init", [(0, True), (1, False)])
def test_pnp_gn_matches_jax(seed, init):
    pts, uv, mask = pnp_case(seed)
    T0 = jse3.se3_exp(jnp.asarray([0.08, -0.03, 0.0, 0.02, 0.0, 0.03], jnp.float32)) if init else None
    want = jp.pnp_gn(pts, uv, mask, FX, FY, CX, CY, T_init=T0, iterations=8)
    got = tp.pnp_gn(t(pts), t(uv), t(mask), FX, FY, CX, CY,
                    T_init=None if T0 is None else t(T0), iterations=8)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(got.mean_px_error), float(want.mean_px_error), rtol=1e-4)
    assert int(got.num_used) == int(want.num_used)


def test_pnp_gn_batched_equals_one_problem_at_a_time():
    cases = [pnp_case(s) for s in (2, 3)]
    pts, uv, mask = (t(np.stack(x)) for x in zip(*cases))
    batched = tp.pnp_gn(pts, uv, mask, FX, FY, CX, CY, iterations=6)
    for k in range(2):
        one = tp.pnp_gn(pts[k], uv[k], mask[k], FX, FY, CX, CY, iterations=6)
        np.testing.assert_allclose(batched.transform[k].numpy(), one.transform.numpy(), atol=1e-6)
        assert int(batched.num_used[k]) == int(one.num_used)


def test_pnp_ransac_matches_jax_with_the_same_draws():
    pts, uv, mask = pnp_case(4)
    key = jax.random.key(5)
    want, want_inl, want_valid = jp.pnp_ransac(pts, uv, mask, key, FX, FY, CX, CY)
    got, inl, valid = tp.pnp_ransac(t(pts), t(uv), t(mask), None, FX, FY, CX, CY,
                                    indices=categorical(key, mask, (64, 4)))
    assert bool(valid) == bool(want_valid)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(want_inl))
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-4, rtol=0)
    # And with the port's own draws it rejects the outliers.
    own, own_inl, own_valid = tp.pnp_ransac(t(pts), t(uv), t(mask), torch.Generator().manual_seed(1),
                                            FX, FY, CX, CY)
    assert bool(own_valid) and not bool(own_inl[:20].any())
    assert float(se3.se3_log(se3.inverse(own.transform) @ got.transform).norm()) < 1e-3
