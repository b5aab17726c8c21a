"""The port's chessboard detector and calibration against the JAX package.

Scenes are ``tests/test_chessboard.py``'s rendered boards and
``tests/test_calibration.py``'s projected boards (numpy, seeded).

Tolerances:
- saddle response: within 1e-5 relative to its maximum against the JAX
  function called eagerly (it is bit-equal there); under ``jit`` XLA
  contracts the ring sums into FMAs, ~1e-7 relative;
- candidates: the same peaks in the same order as the eager JAX function,
  refined within 1e-4 px; against the jitted JAX function (what
  ``detect_chessboard_native`` runs) the same peaks as a set, since its
  FMAs reorder peaks whose responses differ in the last bits;
- ``order_grid`` output equal, and the detected board within 1e-4 px;
- homographies within 1e-4 of their largest entry, K within 1e-3
  relative (fx, fy, cx, cy; the skew, which is near 0, within 1e-3 of
  fx), board poses within 1e-3 (float32 eigh and SVD of LAPACK against
  XLA's; measured: 4e-6, 1e-4, 7e-5; the skew 3e-6 of fx);
- the joint refinement's rms within 1e-4 px and its poses within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops import calibration as jcal
from perception_tpu.ops import chessboard as jcb
from perception_tpu_torch.ops import calibration as cal
from perception_tpu_torch.ops import chessboard as cb
from test_calibration import board_views
from test_chessboard import make_H, render_board

torch.set_num_threads(2)
VIEWS = [(0.0, 0.0), (0.3, 1.2e-4), (-0.5, -8e-5)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def boards():
    return [render_board(make_H(angle=a, px=px), 4, 5) for a, px in VIEWS]


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_saddle_response_matches(boards, view):
    img, gt = boards[view]
    want = np.asarray(jcb.saddle_response(jnp.asarray(img)))
    got = cb.saddle_response(_t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    jitted = np.asarray(jax.jit(jcb.saddle_response)(jnp.asarray(img)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_candidates_match(boards, view):
    img, gt = boards[view]
    cap = 20 + 10
    juv, jm = (np.asarray(x) for x in jcb.find_corner_candidates(jnp.asarray(img), cap, 4))
    uv, m = cb.find_corner_candidates(_t(img), cap, 4)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_allclose(uv.numpy()[jm], juv[jm], rtol=0, atol=1e-4)
    kuv, km = (np.asarray(x) for x in jax.jit(jcb.find_corner_candidates, static_argnums=(1, 2))(
        jnp.asarray(img), cap, 4))
    np.testing.assert_array_equal(m.numpy(), km)
    got = uv.numpy()[km]
    dist = np.linalg.norm(got[:, None] - kuv[km][None], axis=-1)
    assert np.all(dist.min(axis=1) < 1e-4) and np.all(dist.min(axis=0) < 1e-4)


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_detect_and_order_grid_match(boards, view):
    img, gt = boards[view]
    uv, m = cb.find_corner_candidates(_t(img), 30, 4)
    cand = uv.numpy()[m.numpy()]
    np.testing.assert_array_equal(cb.order_grid(cand, 4, 5), jcb.order_grid(cand, 4, 5))
    det = cb.detect_chessboard_native(img, 4, 5, device="cpu")
    jdet = jcb.detect_chessboard_native(img, 4, 5)
    np.testing.assert_allclose(det, jdet, rtol=0, atol=1e-4)
    err = np.linalg.norm(det - gt, axis=-1)
    assert err.max() < 0.7 and err.mean() < 0.4


def test_order_grid_rejects_and_blank():
    pts = np.random.default_rng(0).uniform(0, 100, (10, 2))
    assert cb.order_grid(pts, 4, 5) is None and jcb.order_grid(pts, 4, 5) is None
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 100, (40, 2))
    assert cb.order_grid(pts, 4, 5) is None and jcb.order_grid(pts, 4, 5) is None
    assert cb.detect_chessboard_native(np.full((240, 320), 0.5, np.float32), 4, 5, device="cpu") is None


def test_detect_chessboard_native_backend_scales_uint8(boards):
    img, gt = boards[1]
    det = cal.detect_chessboard((img * 255).astype(np.uint8), 4, 5, device="cpu")
    jdet = jcal.detect_chessboard((img * 255).astype(np.uint8), 4, 5)
    np.testing.assert_allclose(det, jdet, rtol=0, atol=1e-4)


def test_detect_chessboard_cv2_backend(boards):
    cv2 = pytest.importorskip("cv2")  # the card's host has no cv2
    del cv2
    img, gt = boards[0]
    u8 = (img * 255).astype(np.uint8)
    det = cal.detect_chessboard(u8, 4, 5, backend="cv2")
    jdet = jcal.detect_chessboard(u8, 4, 5, backend="cv2")
    if jdet is None:
        assert det is None
    else:
        np.testing.assert_array_equal(det, jdet)


@pytest.fixture(scope="module")
def noisy_views():
    obj, uvs, Ts = board_views(10, noise=0.3, seed=1)
    return np.asarray(obj), np.asarray(uvs), Ts


def test_homography_matches(noisy_views):
    obj, uvs, _ = noisy_views
    want = np.asarray(jax.vmap(lambda uv: jcal.homography_dlt(jnp.asarray(obj), uv))(jnp.asarray(uvs)))
    got = cal.homography_dlt(_t(obj), _t(uvs)).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale)
    one = cal.homography_dlt(_t(obj), _t(uvs[0])).numpy()
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-4 * scale[0, 0, 0])


def test_calibrate_camera_matches(noisy_views):
    obj, uvs, _ = noisy_views
    jK, jTs = (np.asarray(x) for x in jcal.calibrate_camera(jnp.asarray(obj), jnp.asarray(uvs)))
    K, Ts = (x.numpy() for x in cal.calibrate_camera(_t(obj), _t(uvs)))
    diag = [0, 1, 0, 1, 2], [0, 1, 2, 2, 2]  # fx, fy, cx, cy, 1
    np.testing.assert_allclose(K[diag], jK[diag], rtol=1e-3, atol=0)
    assert abs(K[0, 1] - jK[0, 1]) <= 1e-3 * jK[0, 0]  # the skew, near 0: relative to fx
    np.testing.assert_allclose(Ts, jTs, rtol=0, atol=1e-3)
    assert abs(K[0, 0] - 600) < 15 and abs(K[1, 2] - 240) < 10


def test_exact_views_recover_intrinsics():
    obj, uvs, Ts_true = board_views(8, noise=0.0)
    K, Ts = cal.calibrate_camera(_t(obj), _t(uvs))
    np.testing.assert_allclose(K.numpy()[[0, 1, 0, 1], [0, 1, 2, 2]], [600, 590, 320, 240], atol=2.0)
    np.testing.assert_allclose(Ts.numpy()[:, :3, 3], Ts_true[:, :3, 3], atol=0.01)


def test_average_and_pairwise_match():
    obj, uvs0, Ts0 = board_views(6, seed=3)
    T_01 = np.asarray(jse3.se3_exp(jnp.asarray([0.1, 0.0, 0.02, 0.0, 0.15, 0.0], jnp.float32)))
    Ts1 = np.einsum("ij,vjk->vik", np.linalg.inv(T_01), Ts0).astype(np.float32)
    Ts0 = Ts0.astype(np.float32)
    want = np.asarray(jcal.pairwise_extrinsics(jnp.asarray(Ts0), jnp.asarray(Ts1)))
    got = cal.pairwise_extrinsics(_t(Ts0), _t(Ts1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, T_01, atol=1e-4)
    Rs = Ts0[:, :3, :3]
    np.testing.assert_allclose(cal.average_rotations(_t(Rs)).numpy(),
                               np.asarray(jcal.average_rotations(jnp.asarray(Rs))), rtol=0, atol=1e-5)


def test_object_points_equal():
    np.testing.assert_array_equal(cal.chessboard_object_points(6, 9, 0.04),
                                  jcal.chessboard_object_points(6, 9, 0.04))


def test_joint_extrinsics_refine_matches():
    rng = np.random.RandomState(0)
    C, B = 3, 6
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    Ks = np.stack([K] * C)
    obj = cal.chessboard_object_points(4, 5, 0.03)
    obj = np.concatenate([obj, np.zeros((len(obj), 1), np.float32)], 1)
    cam_twists = np.zeros((C, 6), np.float32)
    cam_twists[:, 0] = np.arange(C) * 0.15
    cam_twists[:, 4] = np.arange(C) * -0.1
    T_cam_gt = np.array(jse3.se3_exp(jnp.asarray(cam_twists)))
    T_board_gt = np.array(jse3.se3_exp(jnp.asarray(rng.randn(B, 6).astype(np.float32) * 0.1)))
    T_board_gt[:, 2, 3] += 0.8
    obs = np.zeros((C, B, len(obj), 2), np.float32)
    hom = np.concatenate([obj, np.ones((len(obj), 1))], 1)
    for c in range(C):
        for b in range(B):
            X = (np.linalg.inv(T_cam_gt[c]) @ T_board_gt[b] @ hom.T).T[:, :3]
            obs[c, b] = (X[:, :2] / X[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    obs += rng.randn(*obs.shape).astype(np.float32) * 0.3
    mask = np.ones((C, B), bool)
    mask[2, 1] = False
    pert_c = rng.randn(C, 6).astype(np.float32) * 0.01
    pert_c[0] = 0.0
    T_cam0 = (np.asarray(jse3.se3_exp(jnp.asarray(pert_c))) @ T_cam_gt).astype(np.float32)
    T_board0 = (np.asarray(jse3.se3_exp(jnp.asarray(rng.randn(B, 6).astype(np.float32) * 0.01)))
                @ T_board_gt).astype(np.float32)
    args = (T_cam0, T_board0, Ks, obj, obs, mask)
    jout = [np.asarray(x) for x in jcal.joint_extrinsics_refine(*(jnp.asarray(a) for a in args), iterations=6)]
    out = [x.numpy() for x in cal.joint_extrinsics_refine(*(_t(a) for a in args), iterations=6)]
    np.testing.assert_allclose(out[2], jout[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[3], jout[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[0], jout[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[1], jout[1], rtol=0, atol=1e-4)
    assert out[3] < 0.5 * out[2] and out[3] < 0.5
