"""The port's RANSAC and point-to-plane ICP against the JAX package.

``jax.random`` and torch generators give different numbers, so RANSAC is
fed JAX's own triplets (``ransac._sample_indices`` with the same key).
Tolerances: plane coefficients atol 1e-5 (eigh and reduction order);
inliers equal except at most 2 points whose distance lies within 1e-6
of the threshold. ICP: transform atol 1e-4, fitness rtol 1e-3 and equal
iteration counts (XLA contracts the normal equations into FMAs, torch
does not, and 20 Gauss-Newton steps carry that rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops import icp as jicp
from perception_tpu.ops import ransac as jransac
from perception_tpu_torch.bench import scene
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models import cuboid
from perception_tpu_torch.ops import icp, ransac

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def two_plane_cloud(seed, n=4096):
    """A tilted floor (~70%) and a wall, with noise and a random mask."""
    rng = np.random.RandomState(seed)
    m = int(n * 0.7)
    uv = rng.rand(n, 2) * 0.6 - 0.3
    floor = np.stack([uv[:m, 0], uv[:m, 1], 0.8 + 0.1 * uv[:m, 0]], 1)
    wall = np.stack([uv[m:, 0], np.full(n - m, 0.2), 0.5 + uv[m:, 1]], 1)
    pts = np.concatenate([floor, wall]) + rng.randn(n, 3) * 0.003
    return pts.astype(np.float32), rng.rand(n) < 0.9


def check_plane_fit(fit, jfit, pts, threshold):
    np.testing.assert_allclose(fit.coefficients.numpy(), np.asarray(jfit.coefficients), atol=1e-5, rtol=0)
    assert bool(fit.valid) == bool(jfit.valid)
    inl, jinl = fit.inliers.numpy(), np.asarray(jfit.inliers)
    differ = np.flatnonzero(inl != jinl)
    assert len(differ) <= 2
    c = np.asarray(jfit.coefficients, np.float64)
    dist = np.abs(pts[differ].astype(np.float64) @ c[:3] + c[3])
    assert np.all(np.abs(dist - threshold) < 1e-6)
    assert abs(int(fit.num_inliers) - int(jfit.num_inliers)) <= 2


@pytest.mark.parametrize(
    "model,axis",
    [("plane", None), ("perpendicular", (0.0, -0.1, 1.0)), ("parallel", (0.0, 0.0, 1.0))],
)
def test_ransac_plane_matches_with_jax_triplets(model, axis):
    pts, mask = two_plane_cloud(0)
    key = jax.random.key(3)
    kw = dict(threshold=0.01, num_hypotheses=256, model=model)
    jaxis = None if axis is None else jnp.asarray(axis, jnp.float32)
    jfit = jransac.ransac_plane(jnp.asarray(pts), jnp.asarray(mask), key, axis=jaxis, **kw)
    idx = np.asarray(jransac._sample_indices(key, jnp.asarray(mask), 256))
    fit = ransac.ransac_plane(
        _t(pts), _t(mask), None, indices=_t(idx),
        axis=None if axis is None else torch.tensor(axis), **kw,
    )
    check_plane_fit(fit, jfit, pts, 0.01)
    assert bool(fit.valid)


def test_ransac_plane_on_bench_work_cloud_matches():
    # The pipeline's own RANSAC input: 1024 hypotheses on the 8192-slot
    # downsampled cloud of a bench frame.
    cam = cuboid.PinholeCamera.d435_depth()
    depth = scene.render_depth_tabletop(cam, scene.bench_twist(4), seed=4)
    d, cam2 = cuboid.decimate(torch.from_numpy(depth), cam, 2)
    pts, mask = cam2.backproject_depth(d)
    dpts, dm = (a.numpy() for a in cuboid.ransac_input(pts, mask))
    key = jax.random.key(11)
    jfit = jransac.ransac_plane(jnp.asarray(dpts), jnp.asarray(dm), key, threshold=0.015, num_hypotheses=1024)
    idx = np.asarray(jransac._sample_indices(key, jnp.asarray(dm), 1024))
    fit = ransac.ransac_plane(_t(dpts), _t(dm), indices=_t(idx), threshold=0.015, num_hypotheses=1024)
    check_plane_fit(fit, jfit, dpts, 0.015)


def test_batched_ransac_equals_per_frame():
    clouds = [two_plane_cloud(s, 2048) for s in (1, 2)]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    g = torch.Generator().manual_seed(0)
    idx = ransac._sample_indices(g, _t(mask), 128)
    assert idx.shape == (2, 128, 3) and bool(_t(mask)[torch.arange(2)[:, None, None], idx].all())
    fit = ransac.ransac_plane(_t(pts), _t(mask), indices=idx, threshold=0.01, num_hypotheses=128)
    for b in range(2):
        one = ransac.ransac_plane(_t(pts[b]), _t(mask[b]), indices=idx[b], threshold=0.01, num_hypotheses=128)
        for got, want in zip(fit, one):
            np.testing.assert_array_equal(got[b].numpy(), want.numpy())


def test_scorers_agree_on_bench_shapes():
    pts, mask = two_plane_cloud(3, 8192)
    g = torch.Generator().manual_seed(1)
    idx = ransac._sample_indices(g, _t(mask), 1024)
    P3 = [_t(pts)[idx[:, j]] for j in range(3)]
    normals, d, _ = ransac._plane_from_triplets(*P3)
    fused = ransac._score_fused(_t(pts)[None], _t(mask)[None], normals[None], d[None], 0.015)[0]
    oracle = ransac._score(_t(pts), _t(mask), normals, d, 0.015)
    jscore = jransac._score(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normals.numpy()),
                            jnp.asarray(d.numpy()), 0.015)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(oracle.numpy(), np.asarray(jscore))


def test_sample_indices_are_uniform_over_valid_rows():
    mask = torch.zeros(100, dtype=torch.bool)
    mask[[3, 50, 51, 99]] = True
    idx = ransac._sample_indices(torch.Generator().manual_seed(2), mask, 4000)
    counts = np.bincount(idx.reshape(-1).numpy(), minlength=100)
    assert set(np.flatnonzero(counts)) == {3, 50, 51, 99}
    assert counts.max() < 3300 and counts[[3, 50, 51, 99]].min() > 2700  # ~3000 each


def test_ransac_needs_generator_or_indices():
    pts, mask = two_plane_cloud(4, 64)
    with pytest.raises(ValueError, match="generator or indices"):
        ransac.ransac_plane(_t(pts), _t(mask))
    with pytest.raises(ValueError, match="requires an axis"):
        ransac.ransac_plane(_t(pts), _t(mask), torch.Generator(), model="parallel")


def icp_case(seed):
    """Target: the bench template with its normals; sources: 4 yaw
    restarts of a perturbed, partly masked view of it."""
    tnp = scene.benchmark_template()
    t, tn, tm = (a.numpy() for a in cuboid.template_features(tnp, np.ones(len(tnp), bool), device="cpu"))
    rng = np.random.RandomState(seed)
    n = int(tm.sum())
    T_gt = se3.se3_exp(torch.tensor([0.01, -0.005, 0.004, 0.02, -0.03, 0.15])).numpy()
    src = t[:n][rng.permutation(n)[:700]] @ T_gt[:3, :3].T + T_gt[:3, 3]
    src = np.concatenate([src + rng.randn(700, 3) * 0.001, np.zeros((324, 3))]).astype(np.float32)
    smask = np.arange(1024) < 700
    angles = np.arange(4) * (np.pi / 2)
    twists = np.zeros((4, 6), np.float32)
    twists[:, 5] = angles
    inits = se3.se3_exp(torch.from_numpy(twists)).numpy()
    return src, smask, t, tn, tm, inits


def test_icp_point_to_plane_matches():
    src, smask, t, tn, tm, inits = icp_case(0)
    fn = functools.partial(jicp.icp_point_to_plane, max_iterations=20, transformation_epsilon=1e-12)
    jres = jax.vmap(fn, in_axes=(None, None, None, None, None, 0))(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(t), jnp.asarray(tn), jnp.asarray(tm),
        jnp.asarray(inits),
    )
    res = icp.icp_point_to_plane(
        _t(src).expand(4, -1, -1), _t(smask).expand(4, -1), _t(t), _t(tn), _t(tm), _t(inits),
        max_iterations=20, transformation_epsilon=1e-12,
    )
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(jres.transform), atol=1e-4, rtol=0)
    np.testing.assert_allclose(res.fitness.numpy(), np.asarray(jres.fitness), rtol=1e-3)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_array_equal(res.num_corr.numpy(), np.asarray(jres.num_corr))
    assert float(res.fitness.min()) < 1e-5


def test_icp_lanes_freeze_once_converged():
    src, smask, t, tn, tm, _ = icp_case(1)
    # A loose epsilon makes lanes converge early; a lane's result must not
    # depend on how long the other lanes keep iterating.
    kw = dict(max_iterations=15, transformation_epsilon=1e-6)
    inits = se3.se3_exp(torch.tensor([[0.0] * 6, [0.0, 0, 0, 0, 0, 0.6]])).numpy()
    both = icp.icp_point_to_plane(_t(src).expand(2, -1, -1), _t(smask).expand(2, -1), _t(t), _t(tn),
                                  _t(tm), _t(inits), **kw)
    for r in range(2):
        one = icp.icp_point_to_plane(_t(src), _t(smask), _t(t), _t(tn), _t(tm), _t(inits[r]), **kw)
        assert int(both.iterations[r]) == int(one.iterations)
        np.testing.assert_allclose(both.transform[r].numpy(), one.transform.numpy(), atol=1e-6)
    assert bool(both.converged.any())
    jres = jicp.icp_point_to_plane(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(t), jnp.asarray(tn),
                                   jnp.asarray(tm), jnp.asarray(inits[0]), **kw)
    assert int(jres.iterations) == int(both.iterations[0])


def test_huber_weight_matches():
    r = np.random.RandomState(2).randn(1000).astype(np.float32) * 0.05
    np.testing.assert_array_equal(
        icp._huber_weight(_t(r), 0.02).numpy(), np.asarray(jicp._huber_weight(jnp.asarray(r), 0.02))
    )


def test_inverse_of_icp_result_is_a_pose():
    src, smask, t, tn, tm, inits = icp_case(2)
    res = icp.icp_point_to_plane(_t(src), _t(smask), _t(t), _t(tn), _t(tm), _t(inits[0]))
    T = res.transform
    np.testing.assert_allclose((se3.inverse(T) @ T).numpy(), np.eye(4), atol=1e-5)
    Tj = jse3.inverse(jnp.asarray(T.numpy()))
    np.testing.assert_allclose(se3.inverse(T).numpy(), np.asarray(Tj), atol=1e-6)
