"""The port's last four per-path benchmarks against the JAX repo's scripts:
``bench/profile_stages.py`` (``benchmarks/profile_stages.py``),
``bench/facade_profile.py``, ``bench/sweep_config.py`` and
``bench/decay_sweep.py``.

- Each ``profile_stages`` stage function against the JAX script's stage
  body (jitted, as the script runs it) on the same numpy inputs: each stage
  is fed the JAX side's output of the stage before, at a cut-down
  ``CuboidConfig`` and a 160x120 odometry room (the script's own sizes
  take minutes on the CPU). RANSAC gets the JAX side's triplets.
  Tolerances (XLA's jitted code contracts into FMAs, torch does not):
  compactions, masks, inliers, labels and neighbour indices equal; points
  within 1e-6 m; the plane within 1e-5; the ICP pose within 1e-4 m and
  1e-3 in rotation, fitness rtol 1e-3; odometry poses within 1e-4;
  nearest-neighbour distances within 1e-5.
- Each stage's counted operations and bytes against a hand count at a
  tiny shape.
- ``facade_profile``, ``sweep_config`` and ``decay_sweep`` print the JAX
  scripts' keys, names and lines at a tiny size, and a failing
  ``sweep_config`` variant makes its entry exit 1.
"""

import ast
import dataclasses
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.models import cuboid as jcuboid
from perception_tpu.models.slam import odometry as jodo
from perception_tpu.ops import cluster as jcluster
from perception_tpu.ops import nn as jnn
from perception_tpu.ops import points as JP
from perception_tpu.ops import ransac as jransac
from perception_tpu.ops import voxelhash as jvh
from perception_tpu_torch.bench import decay_sweep, facade_profile, sweep_config
from perception_tpu_torch.bench import profile_stages as ps
from perception_tpu_torch.bench.scene import benchmark_template, render_depth_tabletop
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.cuboid import CuboidConfig
from perception_tpu_torch.models.slam import odometry as todo
from perception_tpu_torch.ops import nn as tnn
from perception_tpu_torch.ops import voxelhash as tvh

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(pre_capacity=4096, work_capacity=2048, box_capacity=512, template_capacity=640,
             ransac_hypotheses=128, icp_restarts=2, icp_max_iterations=6)
CFG = CuboidConfig(**SMALL)
JCFG = jcuboid.CuboidConfig(**SMALL)
ODOM = dict(ps.ODOM, point_budget=256, keyframe_budget=512, icp_iterations=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def cuboid_case():
    """The JAX script's six cuboid stage bodies at CFG, jitted, each on the
    output of the stage before, and what each stage got."""
    jcam = JCamera.d435_depth()
    depth = render_depth_tabletop(PinholeCamera.d435_depth(), seed=0)
    tnp = benchmark_template()
    template, tnormals, tmask = jcuboid.template_features(tnp, np.ones(len(tnp), bool), JCFG)
    key = jax.random.key(0)
    st, o = JCFG.depth_stride, JCFG.depth_stride // 2

    @jax.jit
    def s1(depth):
        d = depth[o::st, o::st]
        cam = dataclasses.replace(jcam, fx=jcam.fx / st, fy=jcam.fy / st, cx=(jcam.cx - o) / st,
                                  cy=(jcam.cy - o) / st, width=d.shape[1], height=d.shape[0])
        pts, m = cam.backproject_depth(d)
        m = JP.passthrough(pts, m, 2, *JCFG.z_limits)
        m = JP.passthrough(pts, m, 0, *JCFG.x_limits)
        return JP.compact(pts, m, JCFG.pre_capacity)

    @jax.jit
    def s2(cpts, cm):
        d0, m0 = JP.voxel_downsample(cpts, cm, JCFG.voxel_size)
        return JP.compact(d0, m0, JCFG.work_capacity)

    @jax.jit
    def s3(dpts, dm, key):
        return jransac.ransac_plane(dpts, dm, key, threshold=JCFG.ransac_threshold,
                                    num_hypotheses=JCFG.ransac_hypotheses)

    @jax.jit
    def s4a(dpts, dm, inl):
        box_pts, box_m = JP.compact(dpts, dm & ~inl, JCFG.box_capacity)
        cl = jcluster.euclidean_cluster(box_pts, box_m, tolerance=JCFG.cluster_tolerance, min_size=1,
                                        max_size=JCFG.box_capacity, max_clusters=8)
        box_m = box_m & (cl.labels == 0)
        return JP.apply_mask(box_pts, box_m), box_m

    @jax.jit
    def s4(box_pts, box_m):
        return jcuboid.estimate_cuboid_pose(box_pts, box_m, template, tmask, JCFG, template_normals=tnormals)

    c = dict(depth=depth, template=(template, tnormals, tmask))
    c["s1"] = s1(jnp.asarray(depth))
    c["s2"] = s2(*c["s1"])
    c["s3"] = s3(*c["s2"], key)
    c["idx"] = _np(jransac._sample_indices(key, c["s2"][1], JCFG.ransac_hypotheses))
    c["s4a"] = s4a(*c["s2"], c["s3"].inliers)
    c["s4"] = s4(*c["s4a"])
    c["full"] = jax.jit(lambda d, k: jcuboid.cuboid_pipeline_from_depth(
        d, jcam, template, tmask, k, JCFG, template_normals=tnormals))(jnp.asarray(depth), key)
    # The full pipeline's own RANSAC input (compact_prefix after the voxels).
    d0, m0 = JP.voxel_downsample(*c["s1"], JCFG.voxel_size)
    c["full_idx"] = _np(jransac._sample_indices(key, JP.compact_prefix(d0, m0, JCFG.work_capacity)[1],
                                                JCFG.ransac_hypotheses))
    return c


def _template(c):
    return tuple(_t(x) for x in c["template"])


def test_backproject_compact_matches_jax(cuboid_case):
    pts, m = ps.backproject_compact(_t(cuboid_case["depth"]), PinholeCamera.d435_depth(), CFG)
    want_pts, want_m = cuboid_case["s1"]
    np.testing.assert_array_equal(m.numpy(), _np(want_m))
    np.testing.assert_allclose(pts.numpy(), _np(want_pts), atol=1e-6, rtol=0)


def test_voxel_compact_matches_jax(cuboid_case):
    pts, m = ps.voxel_compact(*(_t(x) for x in cuboid_case["s1"]), CFG)
    want_pts, want_m = cuboid_case["s2"]
    np.testing.assert_array_equal(m.numpy(), _np(want_m))
    np.testing.assert_allclose(pts.numpy(), _np(want_pts), atol=1e-6, rtol=0)


def test_ransac_stage_matches_jax(cuboid_case):
    fit = ps.ransac_stage(*(_t(x) for x in cuboid_case["s2"]), CFG, indices=_t(cuboid_case["idx"]))
    want = cuboid_case["s3"]
    np.testing.assert_allclose(fit.coefficients.numpy(), _np(want.coefficients), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(fit.inliers.numpy(), _np(want.inliers))
    assert int(fit.num_inliers) == int(want.num_inliers) and bool(fit.valid) == bool(want.valid)


def test_compact_cluster_matches_jax(cuboid_case):
    dpts, dm = cuboid_case["s2"]
    pts, m = ps.compact_cluster(_t(dpts), _t(dm), _t(cuboid_case["s3"].inliers), CFG)
    want_pts, want_m = cuboid_case["s4a"]
    np.testing.assert_array_equal(m.numpy(), _np(want_m))
    np.testing.assert_allclose(pts.numpy(), _np(want_pts), atol=1e-6, rtol=0)
    assert int(m.sum()) > 50


def test_icp_stage_matches_jax(cuboid_case):
    t, n, m = _template(cuboid_case)
    pose, fitness, _ = ps.icp_stage(*(_t(x) for x in cuboid_case["s4a"]), t, m, n, CFG)
    want_pose, want_fit, _ = cuboid_case["s4"]
    np.testing.assert_allclose(pose.numpy()[:3, 3], _np(want_pose)[:3, 3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pose.numpy()[:3, :3], _np(want_pose)[:3, :3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(fitness), float(want_fit), rtol=1e-3)


def test_full_pipeline_matches_jax(cuboid_case):
    t, n, m = _template(cuboid_case)
    res = ps.full_pipeline(_t(cuboid_case["depth"]), PinholeCamera.d435_depth(), t, m, n, CFG,
                           indices=_t(cuboid_case["full_idx"]))
    want = cuboid_case["full"]
    assert bool(res.accepted) == bool(want.accepted) and int(res.num_box_points) == int(want.num_box_points)
    np.testing.assert_allclose(res.plane.numpy(), _np(want.plane), atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.pose.numpy()[:3, 3], _np(want.pose)[:3, 3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(res.pose.numpy()[:3, :3], _np(want.pose)[:3, :3], atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def odom_case():
    """The room at 160x120 (the script's camera scaled), the script's
    odometry settings at cut budgets, and the JAX script's odometry
    stages, jitted, on the same frames."""
    W, H = 160, 120
    fx = 307.0 * W / 320.0
    K = [fx, 0, W / 2, 0, fx, H / 2, 0, 0, 1]
    jcam, cam = JCamera.from_K(K, width=W, height=H), PinholeCamera.from_K(K, width=W, height=H)
    frames = [render_textured_room(cam, T, seed=i)[1] for i, T in enumerate(sweep_trajectory(n=4))]
    jcfg, cfg = jodo.OdometryConfig(**ODOM), todo.OdometryConfig(**ODOM)
    jcfg_m, cfg_m = (dataclasses.replace(c, map_budget=2048) for c in (jcfg, cfg))
    d0, d1 = (jnp.asarray(f) for f in frames[:2])
    c = dict(cam=cam, cfg=cfg, cfg_m=cfg_m, frames=frames)
    c["feat"] = jax.jit(lambda d: jodo._frame_features(jcam, d, jcfg))(d1)
    c["step"] = jax.jit(lambda s, d: jodo.odometry_step(s, d, jcam, jcfg))(jodo.init_state(jcam, d0, jcfg), d1)
    c["step_m"] = jax.jit(lambda s, d: jodo.odometry_step(s, d, jcam, jcfg_m))(jodo.init_state(jcam, d0, jcfg_m), d1)
    rng = np.random.RandomState(0)
    c["q"] = rng.randn(300, 3).astype(np.float32)
    c["ref"] = (rng.randn(1200, 3) * 2.0).astype(np.float32)
    c["nn"] = jax.jit(jnn.nearest_neighbor)(jnp.asarray(c["q"]), jnp.asarray(c["ref"]), jnp.ones(1200, bool))
    c["hash"] = jvh.query(jvh.build(jnp.asarray(c["ref"]), jnp.ones(1200, bool), cell_size=0.3), jnp.asarray(c["q"]))
    return c


def test_frame_features_match_jax(odom_case):
    got = todo._frame_features(odom_case["cam"], _t(odom_case["frames"][1]), odom_case["cfg"])
    for g, w in zip(got, odom_case["feat"]):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), _np(w))
        else:
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["step", "step_m"])
def test_odometry_steps_match_jax(odom_case, mode):
    cfg = odom_case["cfg" if mode == "step" else "cfg_m"]
    cam, (f0, f1) = odom_case["cam"], odom_case["frames"][:2]
    state, diag = todo.odometry_step(todo.init_state(cam, _t(f0), cfg), _t(f1), cam, cfg)
    want_state, want_diag = odom_case[mode]
    np.testing.assert_allclose(state.pose.numpy(), _np(want_state.pose), atol=1e-4, rtol=0)
    assert bool(diag.promoted) == bool(want_diag.promoted)


def test_brute_nn_matches_jax(odom_case):
    q, ref = _t(odom_case["q"]), _t(odom_case["ref"])
    idx, d2 = tnn.nearest_neighbor(q, ref, torch.ones(1200, dtype=torch.bool))
    want_idx, want_d2 = odom_case["nn"]
    np.testing.assert_array_equal(idx.numpy(), _np(want_idx))
    np.testing.assert_allclose(d2.numpy(), _np(want_d2), atol=1e-5, rtol=0)


def test_voxelhash_nn_matches_jax(odom_case):
    vh = tvh.build(_t(odom_case["ref"]), torch.ones(1200, dtype=torch.bool), cell_size=0.3)
    idx, d2 = tvh.query(vh, _t(odom_case["q"]))
    want_idx, want_d2 = odom_case["hash"]
    np.testing.assert_array_equal(idx.numpy(), _np(want_idx))
    np.testing.assert_allclose(d2.numpy(), _np(want_d2), atol=1e-5, rtol=0)


# --- counted operations and bytes, by hand at tiny shapes ---------------------


def test_moved_counts_inputs_once_and_skips_passed_through_outputs():
    a, b = torch.zeros(4, 3), torch.zeros(5, dtype=torch.bool)
    out = torch.zeros(2)
    assert ps.moved((a, a, b), (out, a)) == 48 + 5 + 8


def test_backproject_compact_count():
    cam = PinholeCamera.from_K([4.0, 0, 4.0, 0, 4.0, 3.0, 0, 0, 1], width=8, height=6)
    depth = np.full((6, 8), 0.5, np.float32)
    depth[1, 1] = 0.0  # one decimated pixel invalid
    cfg = CuboidConfig(pre_capacity=8, x_limits=(-10.0, 10.0))
    out = ps.backproject_compact(_t(depth), cam, cfg)
    ops, nbytes, terms = ps.backproject_compact_cost(_t(depth), cfg, out)
    # Stride 2 from row and column 1: 3 x 4 = 12 pixels, 11 valid, 8 kept;
    # each pixel 12 + 2 * 4 + 2 operations; the 12 depths read, (8, 3)
    # points and 8 flags written.
    assert terms == {"pixels": 12, "capacity": 8, "valid": 8}
    assert ops == 12 * 22 and nbytes == 12 * 4 + 8 * 12 + 8


def test_voxel_compact_count():
    pts = _t(np.array([[0.0, 0, 0], [0.001, 0, 0], [0.1, 0, 0], [0.101, 0, 0], [9, 9, 9]], np.float32))
    mask = _t(np.array([True, True, True, True, False]))
    cfg = CuboidConfig(work_capacity=3)
    out = ps.voxel_compact(pts, mask, cfg)
    ops, nbytes, terms = ps.voxel_compact_cost(pts, mask, cfg, out)
    # 4 valid points in 2 voxels: 4 * (19 + 4) + a sort of 4 (4 * 2) + 3 * 2
    # + 5 rows * 2; 5 * 13 bytes read, 3 * 13 written.
    assert terms == {"valid_in": 4, "voxels": 2, "rows_in": 5, "kept": 2}
    assert ops == 92 + 8 + 6 + 10 and nbytes == 65 + 39


def test_ransac_count():
    pts = _t(np.array([[x, y, 0.0] for x in (0.0, 0.1, 0.2) for y in (0.0, 0.1)], np.float32))
    mask = torch.ones(6, dtype=torch.bool)
    cfg = CuboidConfig(ransac_hypotheses=4)
    idx = _t(np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 3, 5]], np.int64))
    fit = ps.ransac_stage(pts, mask, cfg, indices=idx)
    ops, nbytes, terms = ps.ransac_cost(pts, mask, cfg, fit)
    # 4 planes at 32 + 3 * (3 + ceil(log2 6) = 3); K1 9 * 6 * 4; two passes
    # of 9 * 6; 6 inliers at 18; one 3x3 eigh (200). Points and mask read;
    # coefficients, 6 inlier flags, count and flag written.
    assert terms == {"rows": 6, "valid": 6, "hypotheses": 4, "inliers": 6, "k1_ops": 216}
    assert ops == 4 * 50 + 216 + 108 + 108 + 200 and nbytes == 72 + 6 + 16 + 6 + 4 + 1


def test_brute_and_hash_nn_counts():
    ref = _t(np.array([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [0.3, 0, 0], [0.4, 0, 0]], np.float32))
    q = _t(np.array([[0.05, 0, 0], [0.31, 0, 0], [0.12, 0, 0]], np.float32))
    mask = _t(np.array([True, True, True, True, False]))
    ops, nbytes, terms = ps.brute_nn_cost(q, ref, mask, tnn.nearest_neighbor(q, ref, mask))
    # 3 queries x 4 valid points at 9; 36 + 60 + 5 bytes read, int64 indices
    # and float32 distances written.
    assert terms == {"queries": 3, "reference": 4} and ops == 108 and nbytes == 36 + 60 + 5 + 24 + 12
    vh = tvh.build(ref, torch.ones(5, dtype=torch.bool), cell_size=0.1)
    ops, nbytes, terms = ps.hash_nn_cost(vh, q, tvh.query(vh, q))
    # A 2048-row table (5 points padded to a 1024-row block, plus the spare
    # block), the 3 queries in one tile of 128, whose window is one chunk of
    # 512 rows from row 0: 128 * 512 pairs at 9, the 3 queries' cells (19)
    # and their sort (3 * 2). The table (2048 x 8 float32), the cell ids,
    # the queries; int32 indices and distances written.
    assert terms == {"queries": 3, "pairs": 65536, "table_rows": 2048, "k3_ops": 9 * 65536}
    assert ops == 9 * 65536 + 3 * 19 + 6 and nbytes == 2048 * 32 + 5 * 4 + 36 + 12 + 12


def test_icp_count():
    t = _t(np.array([[x, y, 0.0] for x in (0.0, 0.1) for y in (0.0, 0.1)], np.float32))
    n = _t(np.tile(np.float32([0, 0, 1]), (4, 1)))
    tm = torch.ones(4, dtype=torch.bool)
    src = _t(np.array([[0.01, 0.0, 0.002], [0.1, 0.09, 0.001], [0.05, 0.05, 0.0], [9, 9, 9]], np.float32))
    sm = _t(np.array([True, True, True, False]))
    cfg = CuboidConfig(icp_restarts=2, icp_max_iterations=3)
    out = ps.icp_stage(src, sm, t, tm, n, cfg)
    ops, nbytes, terms = ps.icp_cost(src, sm, t, tm, n, cfg, out)
    its = terms["lane_iterations"]
    assert terms["source"] == 3 and terms["template"] == 4 and len(its) == 2 and all(1 <= i <= 3 for i in its)
    # Each lane iteration: 3 x 4 pairs at 9, 3 points at 100, a solve (400);
    # each lane's final statistics: the pairs again and 3 points at 4.
    assert ops == sum(its) * (108 + 300 + 400) + 2 * (108 + 12)
    assert nbytes == 4 * 13 + 4 * 25 + 64 + 4 + 1


def test_cluster_rounds_are_the_settling_rounds(cuboid_case):
    dpts, dm = (_t(x) for x in cuboid_case["s2"])
    inl = _t(cuboid_case["s3"].inliers)
    nb, cells, rounds = ps._cluster_terms(dpts, dm, inl, CFG)
    assert nb == int((dm & ~inl).sum()) and 0 < cells <= nb and 2 <= rounds <= 64
    from perception_tpu_torch.ops import points as P
    from perception_tpu_torch.ops.cluster import euclidean_cluster

    box = P.compact(dpts, dm & ~inl, CFG.box_capacity)

    def labels(r):
        return euclidean_cluster(*box, tolerance=CFG.cluster_tolerance, min_size=1, max_size=CFG.box_capacity,
                                 max_clusters=8, max_iters=r).labels

    # Settled after rounds - 1 (the last round finds no change), not before.
    assert torch.equal(labels(rounds - 1), labels(64))
    assert rounds == 2 or not torch.equal(labels(rounds - 2), labels(64))


def test_step_count_keyframe_mode(odom_case):
    cam, cfg, (f0, f1) = odom_case["cam"], odom_case["cfg"], odom_case["frames"][:2]
    state = todo.init_state(cam, _t(f0), cfg)
    out = todo.odometry_step(state, _t(f1), cam, cfg)
    ops, nbytes, terms = ps.step_cost(state, _t(f1), cam, cfg, out)
    feats = todo._frame_features(cam, _t(f1), cfg)
    ns, nk, px = int(feats[1].sum()), int(state.kf_mask.sum()), 160 * 120
    f_ops = px * (12 + 62) + (256 + 512) * 2
    assert terms["source_valid"] == ns and terms["keyframe_valid"] == nk and terms["features_ops"] == f_ops
    assert ops == f_ops + 3 * (9 * ns * nk + 100 * ns + 400) + 9 * ns * nk + 4 * ns
    assert nbytes > 4 * px


def test_run_stage_records_the_count_and_prints_a_row():
    results = []
    q = _t(np.random.RandomState(1).randn(16, 3).astype(np.float32))
    mask = torch.ones(16, dtype=torch.bool)
    ps._stage(results, "odom/brute-NN(16x16)", tnn.nearest_neighbor, (q, q, mask),
              lambda o: ps.brute_nn_cost(q, q, mask, o), torch.device("cpu"), 2)
    (st,) = results
    # 16 x 16 pairs at 9; the cloud (read once though passed twice) and the
    # mask read, int64 indices and float32 distances written.
    assert st.flops == 2304.0 and st.bytes_accessed == 192 + 16 + 128 + 64
    assert st.terms == {"queries": 16, "reference": 16} and st.launches == {}
    # No peaks on the CPU: no shares.
    assert st.mfu_f32_pct is None and st.hbm_pct is None
    out = {"stages": [dataclasses.asdict(st)]}
    lines = ps.rows(out)
    assert lines[0].startswith("stage") and lines[1].startswith("odom/brute-NN(16x16)")


def test_stage_names_are_the_jax_scripts():
    src = (ROOT / "benchmarks" / "profile_stages.py").read_text()
    names = re.findall(r'measure_stage\(\s*f?"([^"]+)"', src)
    names = [n.replace("{config.icp_restarts}x{config.icp_max_iterations}", "4x20") for n in names]
    port = (ROOT / "perception_tpu_torch" / "bench" / "profile_stages.py").read_text()
    assert len(names) == 12
    for n in names:
        if n.startswith("odom/brute-NN"):
            assert "odom/brute-NN({NN_QUERIES}x{r.shape[0]})" in port
        elif n == "odom/voxelhash-NN(2048x32768)":
            assert "odom/voxelhash-NN({NN_QUERIES}x{NN_LARGE})" in port
        elif n == "odom/step-keyframe(2048x4096)":
            assert "odom/step-keyframe({cfg.point_budget}x{cfg.keyframe_budget})" in port
        elif n == "cuboid/icp(4x20)":
            assert "cuboid/icp({config.icp_restarts}x{config.icp_max_iterations})" in port
        else:
            assert f'"{n}"' in port, n
    assert (ps.NN_QUERIES, ps.NN_SMALL, ps.NN_LARGE) == (2048, 4096, 32768)
    assert ps.ODOM == dict(point_budget=2048, keyframe_budget=4096, icp_iterations=8, min_depth=0.1,
                           max_depth=6.0, normal_max_edge=0.1)
    assert (CuboidConfig().icp_restarts, CuboidConfig().icp_max_iterations) == (4, 20)


# --- the other three scripts' output ------------------------------------------


def test_facade_profile_prints_the_jax_rows(capsys):
    tree = ast.parse((ROOT / "benchmarks" / "facade_profile.py").read_text())
    (subsets,) = [n.iter for n in ast.walk(tree) if isinstance(n, ast.For) and isinstance(n.iter, ast.List)]
    names = [ast.literal_eval(e.elts[0]) for e in subsets.elts]
    assert [n for n, _ in facade_profile.SUBSETS] == names
    rows = facade_profile.run(frames=1, hw=(64, 64), device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["config"] for r in rows] == names
    for r in rows:
        assert list(r) == ["config", "ms_per_frame", "fps"] and r["ms_per_frame"] > 0 and r["fps"] > 0


def test_sweep_config_variants_and_line_are_the_jax_scripts(monkeypatch, capsys):
    import benchmarks.sweep_config as jsweep

    seen = []
    monkeypatch.setattr(jsweep, "run_variant", lambda name, cfg, *a: seen.append((name, cfg)))
    jsweep.main()
    ours = sweep_config.variants()
    assert [n for n, _ in ours] == [n for n, _ in seen]
    for (_, a), (_, b) in zip(ours, seen):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    head, tail = 'f"{name:12s} fps={fps:7.2f}  acc={sum(acc)}/{len(acc)}  ', 'fitness_max={max(fit):.6f}"'
    jsrc = (ROOT / "benchmarks" / "sweep_config.py").read_text()
    assert head + '"' in jsrc and 'f"' + tail in jsrc and 'f"{name:12s} FAILED: {e}"' in jsrc
    tsrc = (ROOT / "perception_tpu_torch" / "bench" / "sweep_config.py").read_text()
    assert head + tail in tsrc and 'f"{name:12s} FAILED: {e}"' in tsrc
    camera, tnp, frames = sweep_config.scenes()
    np.testing.assert_array_equal(frames[3], render_depth_tabletop(
        camera, cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * 3), seed=3))
    capsys.readouterr()
    row = sweep_config.run_variant("base", ours[0][1], camera, tnp, frames[:2], device="cpu", timed=2)
    (line,) = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"base {8} fps= *\d+\.\d\d  acc=\d/2  fitness_max=\d+\.\d{6}", line), line
    assert row["accepted"] == [True, True]


def test_sweep_config_exits_nonzero_when_a_variant_fails(monkeypatch, capsys):
    monkeypatch.setattr(sweep_config, "scenes", lambda: (None, None, None))

    def fake(name, cfg, *a):
        if name == "iters14":
            raise RuntimeError("boom")
        return {"config": name, "fps": 1.0, "accepted": [True], "fitness": [0.0]}

    monkeypatch.setattr(sweep_config, "run_variant", fake)
    assert sweep_config.main(["--cpu"]) == 1
    captured = capsys.readouterr()
    assert "iters14      FAILED: boom" in captured.out and "iters14" in captured.err
    monkeypatch.setattr(sweep_config, "run_variant", lambda name, *a: {"config": name})
    assert sweep_config.main(["--cpu"]) == 0


@pytest.mark.parametrize("argv", [[], ["0.5", "0.75"]])
def test_decay_sweep_rows_are_the_jax_scripts(monkeypatch, capsys, argv):
    import sys

    import benchmarks.decay_sweep as jdecay
    from perception_tpu_torch.bench import slam_bench

    def fake(calls):
        def run(**kw):
            calls.append(kw)
            return {"slam_fps": 12.345, "ate_cm": 0.47003, "keyframes": 35, "loop_closures": 32, "ba_runs": 34}
        return run

    jcalls, tcalls = [], []
    monkeypatch.setattr(jdecay, "run", fake(jcalls))
    monkeypatch.setattr(sys, "argv", ["decay_sweep.py", *argv])
    jdecay.main()
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    monkeypatch.setattr(slam_bench, "run", fake(tcalls))
    got = decay_sweep.run(argv or None, device="cpu")
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == want == [r for r, _ in got]
    assert [r["loop_closures"] for _, r in got] == [32] * len(want)
    assert [dict(kw, device=None) for kw in tcalls] == [dict(kw, device=None) for kw in jcalls]
    assert all(kw["device"] == torch.device("cpu") for kw in tcalls)
    monkeypatch.setattr(sys, "argv", ["decay_sweep.py", *argv])
    decay_sweep.main([*argv, "--cpu"])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == want


def test_benchmarks_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: ps.run(), lambda: facade_profile.run(frames=1), lambda: sweep_config.run(),
               lambda: decay_sweep.run()):
        with pytest.raises(RuntimeError, match="--cpu"):
            fn()
