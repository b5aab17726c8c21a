"""The port's se3, camera, templates and scene helpers against the JAX package.

Tolerances: se3 and backprojection agree within atol 1e-6 (float32
transcendental and matmul rounding differ between XLA and torch); the
numpy copies of the templates and template features agree exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scene as jscene
from perception_tpu.geometry import se3 as jse3
from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.io import templates as jtemplates
from perception_tpu.models import cuboid as jcuboid
from perception_tpu_torch.bench import scene
from perception_tpu_torch.convert import state_from_jax
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.io import templates
from perception_tpu_torch.models import cuboid

torch.set_num_threads(2)
ATOL = 1e-6


def _twists(seed, n=64, scale=1.0):
    rng = np.random.RandomState(seed)
    xi = (rng.randn(n, 6) * scale).astype(np.float32)
    xi[:4, 3:] = 0.0                                   # exact zero rotation
    xi[4:8, 3:] = rng.randn(4, 3).astype(np.float32) * 1e-5  # Taylor branch
    return xi


def test_hat_matches():
    w = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    np.testing.assert_array_equal(se3.hat(torch.from_numpy(w)).numpy(), np.asarray(jse3.hat(jnp.asarray(w))))


@pytest.mark.parametrize("fn", ["so3_exp", "_so3_left_jacobian"])
def test_so3_maps_match_including_taylor_branch(fn):
    w = _twists(1)[:, 3:]
    got = getattr(se3, fn)(torch.from_numpy(w)).numpy()
    want = np.asarray(getattr(jse3, fn)(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_se3_exp_inverse_transform_match(scale):
    xi = _twists(2, scale=scale)
    T = se3.se3_exp(torch.from_numpy(xi))
    Tj = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        se3.inverse(T).numpy(), np.asarray(jse3.inverse(Tj)), atol=ATOL, rtol=0
    )
    pts = np.random.RandomState(3).rand(64, 50, 3).astype(np.float32)
    np.testing.assert_allclose(
        se3.transform_points(T, torch.from_numpy(pts)).numpy(),
        np.asarray(jse3.transform_points(Tj, jnp.asarray(pts))),
        atol=ATOL * 4, rtol=0,  # |T p| up to ~4: a few float32 ulps
    )


def test_make_T_broadcasts():
    R = se3.so3_exp(torch.zeros(5, 3))
    T = se3.make_T(R, torch.ones(3))
    assert T.shape == (5, 4, 4)
    np.testing.assert_array_equal(T.numpy(), np.asarray(jse3.make_T(jnp.asarray(R.numpy()), jnp.ones(3))))


def test_camera_constructors_round_to_float32():
    cam, jcam = PinholeCamera.d435_depth(), JCamera.d435_depth()
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(cam, f) == float(getattr(jcam, f))
    np.testing.assert_array_equal(cam.K, np.asarray(jcam.K))


def test_backproject_matches_with_invalid_pixels_at_origin():
    rng = np.random.RandomState(4)
    depth = (0.3 + rng.rand(48, 64) * 2).astype(np.float32)
    depth[0, :5] = np.nan
    depth[1, :5] = 0.0
    depth[2, :5] = 20.0
    cam = PinholeCamera.from_K([60.0, 0, 31.7, 0, 61.0, 23.2, 0, 0, 1], 64, 48)
    jcam = JCamera.from_K([60.0, 0, 31.7, 0, 61.0, 23.2, 0, 0, 1], 64, 48)
    pts, mask = cam.backproject_depth(torch.from_numpy(depth))
    jpts, jmask = jcam.backproject_depth(jnp.asarray(depth))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=ATOL, rtol=0)
    bad = np.concatenate([np.arange(5) + 64 * r for r in range(3)])
    assert not mask.numpy()[bad].any()
    assert (pts.numpy()[~mask.numpy()] == 0).all()


def test_decimation_matches_the_jax_pipeline():
    depth = np.random.RandomState(5).rand(480, 640).astype(np.float32) + 0.5
    d, cam = cuboid.decimate(torch.from_numpy(depth), PinholeCamera.d435_depth(), 2)
    jcam = JCamera.d435_depth()
    jd = jnp.asarray(depth)[1::2, 1::2]
    jcam = dataclasses.replace(
        jcam, fx=jcam.fx / 2, fy=jcam.fy / 2, cx=(jcam.cx - 1) / 2, cy=(jcam.cy - 1) / 2,
        width=jd.shape[1], height=jd.shape[0],
    )
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(cam, f) == float(getattr(jcam, f))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    pts, mask = cam.backproject_depth(d)
    jpts, jmask = jcam.backproject_depth(jd)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dims,density", [((0.2, 0.1, 0.03), 0.004), ((0.2, 0.1, 0.075), 0.002)])
def test_templates_equal(dims, density):
    np.testing.assert_array_equal(
        templates.cuboid_template(*dims, density=density),
        jtemplates.cuboid_template(*dims, density=density),
    )
    np.testing.assert_array_equal(templates.cuboid_vertices(*dims), jtemplates.cuboid_vertices(*dims))


def test_template_features_equal():
    tnp = scene.benchmark_template()
    np.testing.assert_array_equal(tnp, jscene.benchmark_template())
    mask = np.ones(len(tnp), bool)
    mask[::7] = False
    got = cuboid.template_features(tnp, mask, device="cpu")
    want = jcuboid.template_features(tnp, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_state_from_jax_carries_camera_and_template():
    jcam = JCamera.d435_depth()
    tnp = jscene.benchmark_template()
    jt, jn, jm = jcuboid.template_features(tnp, np.ones(len(tnp), bool))
    st = state_from_jax(np.asarray(jcam.K), jcam.width, jcam.height,
                        np.asarray(jt), np.asarray(jn), np.asarray(jm), device="cpu")
    assert st.camera == PinholeCamera.d435_depth()
    np.testing.assert_array_equal(st.template.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(st.template_normals.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(st.template_mask.numpy(), np.asarray(jm))
    assert st.template.dtype == torch.float32 and st.template_mask.dtype == torch.bool


@pytest.mark.parametrize("seed", [0, 5])
def test_render_depth_tabletop_matches(seed):
    # The cuboid pose enters through se3_exp; an ulp there can flip a
    # pixel on the cuboid's silhouette between box and table, so at most
    # 0.1% of the pixels may differ beyond 1e-5.
    twist = scene.bench_twist(seed)
    got = scene.render_depth_tabletop(PinholeCamera.d435_depth(), twist, seed=seed)
    want = jscene.render_depth_tabletop(JCamera.d435_depth(), twist, seed=seed)
    assert got.shape == want.shape == (480, 640) and got.dtype == np.float32
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 1e-3, off.sum()


def _rotations(seed):
    """Random rotations plus the hard cases: identity, tiny and ~pi angles."""
    w = _twists(seed)[:, 3:]
    w[8:12] *= np.pi / np.linalg.norm(w[8:12], axis=1, keepdims=True) * 0.9999
    return np.array(jse3.so3_exp(jnp.asarray(w)))


def test_matrix_to_quat_and_so3_log_match():
    R = _rotations(6)
    np.testing.assert_allclose(
        se3.matrix_to_quat(torch.from_numpy(R)).numpy(), np.asarray(jse3.matrix_to_quat(jnp.asarray(R))),
        atol=ATOL, rtol=0,
    )
    np.testing.assert_allclose(
        se3.so3_log(torch.from_numpy(R)).numpy(), np.asarray(jse3.so3_log(jnp.asarray(R))),
        atol=4 * ATOL, rtol=0,  # |omega| up to pi
    )


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_se3_log_inverts_exp_and_matches(scale):
    xi = _twists(7, scale=scale)
    xi[:, 3:] *= np.minimum(1.0, 2.5 / np.linalg.norm(xi[:, 3:] + 1e-12, axis=1, keepdims=True))
    T = se3.se3_exp(torch.from_numpy(xi))
    got = se3.se3_log(T).numpy()
    want = np.asarray(jse3.se3_log(jnp.asarray(T.numpy())))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)  # the V solve amplifies ulps
    np.testing.assert_allclose(got, xi, atol=1e-4 * max(scale, 0.1), rtol=0)


def test_orthonormalize_T_and_rotate_points_match():
    rng = np.random.RandomState(8)
    T = se3.se3_exp(torch.from_numpy(_twists(8)))
    T[:, :3] += torch.from_numpy((rng.randn(64, 3, 4) * 1e-3).astype(np.float32))  # off SO(3)
    got = se3.orthonormalize_T(T)
    want = jse3.orthonormalize_T(jnp.asarray(T.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    R = got[:, :3, :3]
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-6)
    v = rng.randn(64, 20, 3).astype(np.float32)
    np.testing.assert_allclose(
        se3.rotate_points(got, torch.from_numpy(v)).numpy(),
        np.asarray(jse3.rotate_points(want, jnp.asarray(v))),
        atol=4 * ATOL, rtol=0,
    )
