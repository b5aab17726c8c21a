"""The port's small leftovers against the JAX package: ``nn.radius_count``,
``points.crop_box``, ``metrics.rpe``, ``se3.vee`` / ``se3.orthonormalize``,
``StereoCamera`` and ``io/bvh.save_bvh``; and ``points.segment_sum``, the
fixed-order segment sum of the centroids, against rows added in order.

Tolerances: radius counts equal on points more than 1e-5 from the radius
(both sides use the tiled |q|^2 - 2 q.r + |r|^2 form, which rounds near the
radius); crop_box equal; rpe within 1e-9 (float64 numpy both sides); vee
and orthonormalize within 1e-6 (float32 SVD); StereoCamera within 1e-6
relative; the BVH text equal byte for byte; segment_sum equal to rows
added in order, bit for bit, and within 1e-3 of ``jax.ops.segment_sum``
(which adds ~700 rows of magnitude ~10 a segment in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.geometry.stereo import StereoCamera as JStereo
from perception_tpu.io.bvh import save_bvh as jsave_bvh
from perception_tpu.models.pose import BODY_25_PAIRS, BODY_25_PARTS
from perception_tpu.ops import nn as jnn
from perception_tpu.ops import points as jpoints
from perception_tpu.utils.metrics import rpe as jrpe
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.geometry.stereo import MISSING_Z, StereoCamera
from perception_tpu_torch.io.bvh import save_bvh
from perception_tpu_torch.models import pose as tpose
from perception_tpu_torch.ops import nn, points
from perception_tpu_torch.utils.metrics import rpe

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,tile", [(0, 4096), (1, 64), (2, 100)])
def test_radius_count_matches(seed, tile):
    rng = np.random.RandomState(seed)
    q = (rng.randn(300, 3) * 0.1).astype(np.float32)
    r = (rng.randn(1000, 3) * 0.1).astype(np.float32)
    m = rng.rand(1000) > 0.2
    radius = 0.05
    want = np.asarray(jnn.radius_count(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), radius, tile=tile))
    got = nn.radius_count(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(m), radius, tile=tile)
    assert got.dtype == torch.int32
    d = np.sqrt(((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1))
    near = (np.abs(d - radius) <= 1e-5) & m[None]
    clear = ~near.any(axis=1)
    assert clear.sum() > 250
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    exact = ((d <= radius) & m[None]).sum(1)
    np.testing.assert_array_equal(got.numpy()[clear], exact[clear])


def test_radius_count_jax_case():
    q = torch.tensor([[0.0, 0, 0]])
    r = torch.tensor([[0.05, 0, 0], [0.2, 0, 0], [0, 0.09, 0], [5, 5, 5]])
    assert int(nn.radius_count(q, r, torch.ones(4, dtype=torch.bool), radius=0.1)[0]) == 2


def test_crop_box_matches():
    rng = np.random.RandomState(3)
    p = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    p[0, :5] = [[0.5, 0.2, -0.3], [-0.5, 0.2, 0.3], [0.2, 0.5, 0.0], [0.0, 0.0, 0.5], [0.1, -0.2, 0.3]]
    m = rng.rand(2, 500) > 0.1
    lo, hi = (-0.5, -0.2, -0.3), (0.5, 0.5, 0.3)
    want = np.asarray(jpoints.crop_box(jnp.asarray(p), jnp.asarray(m), lo, hi))
    got = points.crop_box(torch.from_numpy(p), torch.from_numpy(m), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :3], m[0, :3])  # inclusive bounds
    assert not got[0, 3]


def _traj(seed, n=30):
    rng = np.random.RandomState(seed)
    xi = rng.randn(n, 6).astype(np.float32) * 0.3
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches(delta):
    gt = _traj(0)
    est = gt.copy()
    est[:, :3, 3] += np.random.RandomState(1).randn(30, 3) * 0.01
    got, want = rpe(est, gt, delta), jrpe(est, gt, delta)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert got[0] > 0.005


def test_rpe_scale_error():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.1
    est = gt.copy()
    est[:, 0, 3] *= 1.1
    np.testing.assert_allclose(rpe(est, gt, 1), jrpe(est, gt, 1), atol=1e-9)
    np.testing.assert_allclose(rpe(est, gt, 1)[0], 0.01, atol=1e-6)


def test_vee_matches():
    w = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    S = np.array(jse3.hat(jnp.asarray(w)))
    np.testing.assert_allclose(se3.vee(torch.from_numpy(S)).numpy(), np.asarray(jse3.vee(jnp.asarray(S))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(se3.vee(se3.hat(torch.from_numpy(w))).numpy(), w, atol=1e-6)


def test_orthonormalize_matches():
    rng = np.random.RandomState(4)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.randn(16, 3).astype(np.float32))))
    noisy = (R + rng.randn(16, 3, 3) * 0.05).astype(np.float32)
    noisy[0] = -noisy[0]  # det -1: the SVD's flip
    want = np.asarray(jse3.orthonormalize(jnp.asarray(noisy)))
    got = se3.orthonormalize(torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_stereo_matches():
    cam = PinholeCamera.d435_depth()
    jcam = JCamera.d435_depth()
    st, jst = StereoCamera(left=cam, baseline=0.05), JStereo(left=jcam, baseline=jnp.float32(0.05))
    np.testing.assert_allclose(st.Q.numpy(), np.asarray(jst.Q), rtol=1e-6, atol=0)
    rng = np.random.RandomState(5)
    disp = rng.uniform(-2, 60, (24, 32)).astype(np.float32)
    disp[0, :3] = 0.0
    for name in ("disparity_to_depth",):
        np.testing.assert_allclose(getattr(st, name)(torch.from_numpy(disp)).numpy(),
                                   np.asarray(getattr(jst, name)(jnp.asarray(disp))), rtol=1e-6, atol=0)
    pts, ok = st.disparity_image_to_3d(torch.from_numpy(disp))
    jpts, jok = jst.disparity_image_to_3d(jnp.asarray(disp))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-6, atol=1e-6)
    assert np.all(pts.numpy()[~ok.numpy()] == [0.0, 0.0, MISSING_Z])
    depth = rng.uniform(0.3, 5.0, 100).astype(np.float32)
    d = st.depth_to_disparity(torch.from_numpy(depth))
    np.testing.assert_allclose(d.numpy(), np.asarray(jst.depth_to_disparity(jnp.asarray(depth))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(st.disparity_to_depth(d).numpy(), depth, rtol=1e-5)


def test_bvh_text_matches(tmp_path):
    assert tpose.BODY_25_PARTS == list(BODY_25_PARTS)
    np.testing.assert_array_equal(tpose.BODY_25_PAIRS, BODY_25_PAIRS)
    rng = np.random.RandomState(0)
    base = rng.rand(25, 3)
    frames = [base + 0.01 * t + rng.randn(25, 3) * 0.02 for t in range(12)]
    frames[3][4] = frames[3][3]  # a zero-length limb: identity rotation
    save_bvh(tmp_path / "port.bvh", frames, tpose.BODY_25_PAIRS, tpose.BODY_25_PARTS, fps=25.0)
    jsave_bvh(tmp_path / "jax.bvh", frames, BODY_25_PAIRS, BODY_25_PARTS, fps=25.0)
    a, b = (tmp_path / "port.bvh").read_bytes(), (tmp_path / "jax.bvh").read_bytes()
    assert a == b
    assert a.startswith(b"HIERARCHY") and b"Frames: 12" in a


@pytest.mark.parametrize("shape", [(5000,), (5000, 3)])
def test_segment_sum_adds_rows_in_order(shape):
    rng = np.random.RandomState(6)
    v = (rng.randn(*shape) * 10).astype(np.float32)
    ids = rng.randint(0, 7, shape[0])
    want = np.zeros((8,) + shape[1:], np.float32)
    for i, s in enumerate(ids):
        want[s] = want[s] + v[i]
    got = points.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), 8).numpy()
    np.testing.assert_array_equal(got, want)
    jwant = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=8))
    np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-3)
