"""Parts of the port's SLAM odometry against the JAX package: the state
conversion and one step from it, the frame features, the map fusion; and
the numpy copies of the SLAM scene and the ATE metric.

Scene, configurations and tolerances as in ``test_torch_odometry.py``
(one jitted JAX step against eager PyTorch): poses and map points within
atol 1e-5, frame-feature points within 1e-6, masks equal. The scene copy
renders the JAX copy's depth within 1e-6 m wherever both hit the same
plane; the trajectory poses agree within 1e-6 (``se3_exp`` of each
package). ATE equals the JAX package's to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import slam_scene as jscene
from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.models.slam import odometry as jodo
from perception_tpu.utils import metrics as jmetrics
from perception_tpu_torch.bench import slam_scene
from perception_tpu_torch.convert import odometry_state_from_jax
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import odometry as odo
from perception_tpu_torch.utils import metrics
from test_odometry import render_room_depth, small_camera
from test_torch_odometry import BASE, assert_diags_close, configs, scene  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("engine", ["keyframe-fused", "map-hash"])
def test_one_step_from_the_converted_jax_state(scene, engine):
    """odometry_state_from_jax carries a mid-run state (after a promotion
    and, with the hash engine, a rebuilt hash); one step from it agrees."""
    jcam, cam, _, depths = scene
    jcfg, cfg = configs(engine)
    jstate = jodo.init_state(jcam, jnp.asarray(depths[0]), jcfg)
    for d in depths[1:4]:
        jstate, _ = jodo.odometry_step(jstate, jnp.asarray(d), jcam, jcfg)
    assert int(jstate.num_keyframes) == 2
    state = odometry_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert state.frame_index.dtype == torch.int32 and state.kf_mask.dtype == torch.bool
    np.testing.assert_array_equal(state.map_hash.cell_ids.numpy(), np.asarray(jstate.map_hash.cell_ids))

    jnew, jdiag = jodo.odometry_step(jstate, jnp.asarray(depths[4]), jcam, jcfg)
    new, diag = odo.odometry_step(state, torch.from_numpy(depths[4]), cam, cfg)
    assert_diags_close(diag, jdiag)
    for name in ("pose", "kf_pose", "kf_points", "kf_normals", "map_points", "map_normals"):
        np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for name in ("kf_mask", "map_mask", "frame_index", "num_keyframes"):
        np.testing.assert_array_equal(getattr(new, name).numpy(), np.asarray(getattr(jnew, name)))


def test_frame_features_match_with_phase(scene):
    jcam, cam, _, depths = scene
    jcfg, cfg = configs("keyframe-auto")
    got = odo._frame_features(cam, torch.from_numpy(depths[2]), cfg,
                              phase=torch.tensor(5 * 97, dtype=torch.int32))
    want = jodo._frame_features(jcam, jnp.asarray(depths[2]), jcfg, phase=jnp.int32(5 * 97))
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("decay", [1.0, 0.25])
def test_fuse_map_matches(scene, decay):
    jcam, cam, _, depths = scene
    jcfg, cfg = (dataclasses.replace(c, map_budget=1500, map_decay=decay) for c in configs("map-auto"))
    _, _, kp, kn, km = odo._frame_features(cam, torch.from_numpy(depths[0]), cfg)
    _, _, kp2, kn2, km2 = odo._frame_features(cam, torch.from_numpy(depths[3]), cfg)
    mp, mn, mm = odo._fuse_map(torch.full((1500, 3), 1e6), torch.zeros(1500, 3),
                               torch.zeros(1500, dtype=torch.bool), kp, kn, km, cfg)
    got = odo._fuse_map(mp, mn, mm, kp2, kn2, km2, cfg)
    want = jodo._fuse_map(*(jnp.asarray(t.numpy()) for t in (mp, mn, mm, kp2, kn2, km2)), jcfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    assert int(got[2].sum()) == 1500  # over budget: decimated to capacity


def test_static_camera_keeps_pose_and_keyframe(scene):
    _, cam, _, _ = scene
    jcam = small_camera()
    cfg = odo.OdometryConfig(**BASE)
    state = odo.init_state(cam, torch.from_numpy(render_room_depth(jcam, np.eye(4), seed=0)), cfg)
    state, diag = odo.odometry_step(state, torch.from_numpy(render_room_depth(jcam, np.eye(4), seed=1)), cam, cfg)
    assert float(state.pose[:3, 3].norm()) < 0.005
    assert not bool(diag.promoted) and int(state.num_keyframes) == 1


def test_slam_scene_copy_matches():
    w, h = 96, 72
    fx = 307.0 * w / 320.0
    K = [fx, 0, w / 2, 0, fx, h / 2, 0, 0, 1]
    traj = slam_scene.sweep_trajectory(n=40)
    jtraj = jscene.sweep_trajectory(n=40)
    np.testing.assert_allclose(np.stack(traj), np.stack(jtraj), atol=1e-6, rtol=0)
    for i in (0, 7, 23):
        g, d = slam_scene.render_textured_room(PinholeCamera.from_K(K, w, h), jtraj[i], seed=i)
        jg, jd = jscene.render_textured_room(JCamera.from_K(K, w, h), jtraj[i], seed=i)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(d, jd)
        assert d.dtype == np.float32 and d.shape == (h, w) and (d > 0).all()


@pytest.mark.parametrize("align", [False, True])
def test_ate_matches(align):
    rng = np.random.RandomState(9)
    gt = np.stack(slam_scene.sweep_trajectory(n=30))
    est = gt.copy()
    est[:, :3, 3] += rng.randn(30, 3) * 0.01
    got = metrics.ate(est, gt, align=align)
    want = jmetrics.ate(est, gt, align=align)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_shortlist_ties_keep_the_lower_index(scene):
    """Map mode's shortlist (``map_nn_recall < 1``) over a map whose points
    each have an exact copy with another normal: every candidate distance
    ties with its copy's. The JAX package's ``approx_max_k`` falls back to
    an exact top-k on the CPU and gives ties lower index first, and its
    shortlist argmin then takes the lower copy; the port must pick the same
    copies, or the GN step takes the other normals."""
    jcam, cam, _, depths = scene
    jcfg, cfg = configs("map-auto")
    assert cfg.map_nn_recall < 1.0 and odo._map_engine(cfg) == "shortlist"
    jstate = jodo.init_state(jcam, jnp.asarray(depths[0]), jcfg)
    pts, nrm, mask = (np.array(a) for a in (jstate.map_points, jstate.map_normals, jstate.map_mask))
    live = np.flatnonzero(mask)
    half = len(live) // 2
    lo, hi = live[:half], live[half:2 * half]
    # The lower slot gets the copy; the higher keeps the point with its
    # normal turned a quarter turn, so the two candidates' residuals differ.
    pts[lo], nrm[lo] = pts[hi], nrm[hi]
    nrm[hi] = np.cross(nrm[hi], np.array([0.3, 0.5, 0.8], np.float32))
    nrm[hi] /= np.linalg.norm(nrm[hi], axis=1, keepdims=True)
    jstate = jstate._replace(map_points=jnp.asarray(pts), map_normals=jnp.asarray(nrm))

    # The shortlist itself, on one distance matrix (rows = source points).
    rng = np.random.RandomState(0)
    q = pts[rng.choice(live, 64)] + rng.randn(64, 3).astype(np.float32) * 0.01
    masked = np.where(mask[:, None], pts, np.float32(1e6)).astype(np.float32)
    d2 = (np.sum(q * q, 1)[:, None] - 2.0 * (q @ masked.T) + np.sum(masked * masked, 1)[None]).astype(np.float32)
    _, jidx = jax.lax.approx_max_k(-jnp.asarray(d2), cfg.map_nn_shortlist, recall_target=cfg.map_nn_recall)
    idx, d2k = odo._nearest_k(torch.from_numpy(d2), cfg.map_nn_shortlist)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2k.numpy(), np.take_along_axis(d2, np.asarray(jidx), 1))
    assert (d2k[:, 1:] == d2k[:, :-1]).sum() > 64  # the copies tie

    # The GN step from that map.
    state = odometry_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    jnew, jdiag = jodo.odometry_step(jstate, jnp.asarray(depths[1]), jcam, jcfg)
    new, diag = odo.odometry_step(state, torch.from_numpy(depths[1]), cam, cfg)
    assert_diags_close(diag, jdiag)
    np.testing.assert_allclose(new.pose.numpy(), np.asarray(jnew.pose), atol=1e-5, rtol=0)


def test_fixed_order_forms_agree_with_the_matmul_forms(scene):
    """Map mode's shortlist engine poses its points and forms its distances
    from explicit products added in a fixed order (the same on the card and
    the CPU) where it used K=3 and 4x4 matmuls. On the room's map the two
    forms agree within the parity tolerance above (1e-5): the warm start,
    the posed points, the distance matrix and the brute polish's nearest
    distances; the shortlist's candidates are the whole matrix's exact
    (value, index) top-k."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.ops import nn

    jcam, cam, _, depths = scene
    _, cfg = configs("map-auto")
    state = odo.init_state(cam, torch.from_numpy(depths[0]), cfg)
    kf = se3.se3_exp(torch.tensor([0.31, -0.12, 0.07, 0.05, -0.21, 0.13]))
    pose = kf @ se3.se3_exp(torch.tensor([0.02, 0.01, -0.01, 0.01, 0.02, -0.01]))
    T0 = odo._relative(kf, pose)
    np.testing.assert_allclose(T0.numpy(), (se3.inverse(kf) @ pose).numpy(), atol=1e-6, rtol=0)
    src = odo._frame_features(cam, torch.from_numpy(depths[1]), cfg)[0]
    src_t = odo._posed(T0, src)
    np.testing.assert_allclose(src_t.numpy(), se3.transform_points(T0, src).numpy(), atol=1e-5, rtol=0)

    map_masked = odo.apply_mask(state.map_points, state.map_mask)
    map_sq = odo._sq_norm(map_masked)
    d2 = odo._shortlist_d2(src_t, map_masked, map_sq, tile=1000)
    matmul = (torch.sum(src_t * src_t, 1)[:, None] - 2.0 * (src_t @ map_masked.T)
              + torch.sum(map_masked * map_masked, 1)[None])
    np.testing.assert_allclose(d2.numpy(), matmul.numpy(), atol=1e-5, rtol=0)
    idx, best = odo._map_nearest(src_t, map_masked, map_sq, tile=1000)
    _, want = nn.nearest_neighbor(src_t, map_masked, state.map_mask)
    np.testing.assert_allclose(best.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(best.numpy(), torch.clamp(d2.gather(1, idx[:, None])[:, 0], min=0).numpy())
    k = cfg.map_nn_shortlist
    np.testing.assert_array_equal(odo._shortlist_candidates(src_t, map_masked, map_sq, k).numpy(),
                                  odo._nearest_k(d2, k)[0].numpy())
