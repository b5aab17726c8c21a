"""The port's bundle adjustment and pose-graph optimization against the
JAX package, on ``make_ba_problem`` and ``make_loop_graph`` of
``test_backend.py``.

The port solves BA's reduced camera system by the JAX package's
unpivoted Gauss-Jordan with a guarded pivot (``_gauss_solve``) and the
pose graph by LU with partial pivoting (``solve_ex``), and adds its
segment sums in another order. Tolerances, as measured:

- ``_gauss_solve`` against the JAX package's on a gauged 30 x 30 system
  (6 x ``ba_window``): damped SPD, solutions within 4.6e-6 of max |x|;
  with an exact zero pivot (an unobserved pose at lam = 0), within
  3.7e-6, finite. Held to 5e-5 of max |x| (the jitted side contracts
  into FMAs). ``ba_schur_solve`` on BA blocks giving those systems: dxi
  and dX within 1.2e-5 of their max |.| (held to 1e-4), finite; LU with
  partial pivoting returns a non-finite step on the zero-pivot system.
- ``bundle_adjust`` on the problem of the first BA run of the port's
  ``run_slam`` over 12 frames of the 160 x 120 sweep in map mode (built
  at 8 torch threads, where LU met an exact zero pivot in the first
  iteration and the non-finite step was accepted at a cost of 0.0): at 8
  and at 1 thread, poses and landmarks finite and the final cost within
  rtol 2e-6 of the JAX package's 0.171108, held to rtol 1e-4.
- ``bundle_adjust`` with the depth residual pinning the scale gauge (as
  the SLAM system runs it): poses within 3.1e-6, landmarks 9.6e-7, costs
  rtol 5.4e-6; held to atol 2e-5 and rtol 1e-4.
- ``bundle_adjust`` on pure reprojection: the scale gauge is free, so
  rounding slides the solution along it: poses within 2.1e-4 and
  landmarks 9.1e-4 after 12 iterations (held to 1e-3 and 5e-3), costs
  rtol 5.9e-6 (held to 1e-4).
- ``ba_blocks``: every block within rtol 1e-5 of the JAX package's.
- ``optimize_pose_graph``: poses within 2.9e-5 (held to 1e-4), costs
  rtol 1e-5 (held to 1e-4).
- ``pose_graph_system``: residuals within 1.8e-7, Jacobian blocks within
  1.8e-7 of the jitted ``jax.jacfwd``'s (held to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.models.slam import backend as jb
from perception_tpu_torch.models.slam import backend as tb
from test_backend import CX, CY, FX, FY, make_ba_problem, make_loop_graph

torch.set_num_threads(2)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def depth_pinned_problem(seed):
    """make_ba_problem with each observation's true depth, weighted fx/z."""
    p, poses, lms = make_ba_problem(seed=seed)
    T_cw = np.linalg.inv(poses)[np.asarray(p.obs_pose)]
    z = np.einsum("oj,oj->o", T_cw[:, 2, :3], lms[np.asarray(p.obs_lm)]) + T_cw[:, 2, 3]
    return p._replace(obs_z=jnp.asarray(z, jnp.float32), obs_zw=jnp.asarray(FX / z, jnp.float32))


def assert_ba_close(p, iterations, atol_pose, atol_lm, rtol_cost):
    want = jb.bundle_adjust(p, FX, FY, CX, CY, iterations=iterations)
    got = tb.bundle_adjust(tb.BAProblem(*(t(x) for x in p)), FX, FY, CX, CY, iterations=iterations)
    np.testing.assert_allclose(got.poses_wc.numpy(), np.asarray(want.poses_wc), atol=atol_pose, rtol=0)
    np.testing.assert_allclose(got.landmarks.numpy(), np.asarray(want.landmarks), atol=atol_lm, rtol=0)
    for g, w in ((got.initial_cost, want.initial_cost), (got.final_cost, want.final_cost)):
        np.testing.assert_allclose(float(g), float(w), rtol=rtol_cost)
    assert float(got.final_cost) < float(got.initial_cost)


@pytest.mark.parametrize("seed,iterations", [(0, 4), (5, 12)])
def test_bundle_adjust_with_depth_matches_jax(seed, iterations):
    assert_ba_close(depth_pinned_problem(seed), iterations, 2e-5, 2e-5, 1e-4)


def test_bundle_adjust_reprojection_only_matches_jax():
    assert_ba_close(make_ba_problem()[0], 12, 1e-3, 5e-3, 1e-4)


def test_bundle_adjust_respects_obs_mask():
    p = depth_pinned_problem(2)
    # Every other observation corrupted and masked (each pose keeps half
    # of its observations, so the frozen pose 0 still fixes the gauge).
    bad = jnp.arange(p.obs_uv.shape[0]) % 2 == 0
    p = p._replace(obs_uv=jnp.where(bad[:, None], p.obs_uv + 500.0, p.obs_uv), obs_mask=~bad)
    assert_ba_close(p, 8, 2e-5, 2e-5, 1e-4)


def test_ba_blocks_match_jax():
    p = depth_pinned_problem(1)
    M, L = p.poses_wc.shape[0], p.landmarks.shape[0]
    T_cw = jse3.inverse(p.poses_wc)
    args = (p.obs_pose, p.obs_lm, p.obs_uv, p.obs_mask, FX, FY, CX, CY, M, L, 3.0, p.obs_z, p.obs_zw)
    want = jb.ba_blocks(T_cw, p.landmarks, *args)
    got = tb.ba_blocks(t(T_cw), t(p.landmarks), *(t(a) if hasattr(a, "shape") else a for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_pose_graph_system_matches_jacfwd():
    graph, _ = make_loop_graph(drift=0.05, seed=1)
    Tm_inv = jse3.inverse(graph.edge_T)
    w = graph.edge_weight.at[3].set(0.0)
    want = jax.jit(jb.pose_graph_system)(graph.poses_wc, graph.edge_i, graph.edge_j, Tm_inv, w)
    got = tb.pose_graph_system(t(graph.poses_wc), t(graph.edge_i), t(graph.edge_j), t(Tm_inv), t(w))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5, rtol=0)
    # A zero-weight edge has a zero residual and zero blocks.
    assert all(not g[3].any() for g in got)


@pytest.mark.parametrize("kw,iterations", [(dict(), 15), (dict(N=24, drift=0.01, seed=3), 8)])
def test_optimize_pose_graph_matches_jax(kw, iterations):
    graph, _ = make_loop_graph(**kw)
    want, wc0, wc1 = jb.optimize_pose_graph(graph, iterations=iterations)
    got, c0, c1 = tb.optimize_pose_graph(tb.PoseGraph(*(t(x) for x in graph)), iterations=iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose([float(c0), float(c1)], [float(wc0), float(wc1)], rtol=1e-4)
    assert float(c1) < float(c0) * 0.2


def test_inv3_inverts():
    A = torch.from_numpy(np.random.RandomState(0).randn(10, 3, 3).astype(np.float32)) + 3 * torch.eye(3)
    np.testing.assert_allclose((tb._inv3(A) @ A).numpy(), np.broadcast_to(np.eye(3), (10, 3, 3)), atol=1e-5)


def ba_system_blocks(seed, unobserved=None, M=5, L=40, O=400):
    """BA normal-equation blocks summed from random per-observation
    Jacobians (each observation touches one pose and one landmark), as
    ``ba_blocks`` builds them. Pose ``unobserved`` gets no observation."""
    rng = np.random.RandomState(seed)
    poses = rng.randint(0, M, O)
    if unobserved is not None:
        poses[poses == unobserved] = (unobserved + 1) % M
    lms = rng.randint(0, L, O)
    Jp = rng.randn(O, 2, 6).astype(np.float32)
    Jl = rng.randn(O, 2, 3).astype(np.float32)
    r = rng.randn(O, 2).astype(np.float32)
    Hpp, Hll = np.zeros((M, 6, 6), np.float32), np.zeros((L, 3, 3), np.float32)
    U = np.zeros((L, M, 6, 3), np.float32)
    bp, bl = np.zeros((M, 6), np.float32), np.zeros((L, 3), np.float32)
    for o in range(O):
        m, l = poses[o], lms[o]
        Hpp[m] += Jp[o].T @ Jp[o]
        Hll[l] += Jl[o].T @ Jl[o]
        U[l, m] += Jp[o].T @ Jl[o]
        bp[m] -= Jp[o].T @ r[o]
        bl[l] -= Jl[o].T @ r[o]
    return Hpp, Hll, U, bp, bl


def reduced_system(case):
    """The gauged reduced camera system (S, rhs), 30 x 30, of
    ``ba_system_blocks``: damped (lam 1e-3) and SPD, or at lam 0 with pose
    2 unobserved, whose rows and columns of S are then exactly zero."""
    unobserved, lam = (2, 0.0) if case == "zero pivot" else (None, 1e-3)
    Hpp, Hll, U, bp, bl = (torch.from_numpy(a) for a in ba_system_blocks(0, unobserved))
    M, L = Hpp.shape[0], Hll.shape[0]
    Hinv = torch.linalg.inv(Hll + lam * torch.eye(3))
    S = torch.zeros(M, 6, M, 6)
    for m in range(M):
        S[m, :, m] = Hpp[m] + lam * torch.eye(6)
    S -= torch.einsum("lkac,lcd,lmbd->kamb", U, Hinv, U)
    rhs = bp - torch.einsum("lkac,lcd,ld->ka", U, Hinv, bl)
    return tb._gauge(S.reshape(6 * M, 6 * M), rhs.reshape(6 * M))


@pytest.mark.parametrize("case", ["damped spd", "zero pivot"])
def test_gauss_solve_matches_jax(case):
    A, b = reduced_system(case)
    if case == "zero pivot":
        assert not A[12:18].any() and not A[:, 12:18].any()
    got = tb._gauss_solve(A, b).numpy()
    want = np.asarray(jb._gauss_solve(jnp.asarray(A.numpy()), jnp.asarray(b.numpy())))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["damped spd", "zero pivot"])
def test_ba_schur_solve_matches_jax(case):
    unobserved, lam = (2, 0.0) if case == "zero pivot" else (None, 1e-3)
    blocks = ba_system_blocks(1, unobserved)
    M, L = blocks[0].shape[0], blocks[1].shape[0]
    want = jb.ba_schur_solve(*(jnp.asarray(a) for a in blocks), lam, M, L)
    got = tb.ba_schur_solve(*(torch.from_numpy(a) for a in blocks), torch.tensor(lam), M, L)
    for g, w in zip(got[:2], want[:2]):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.fixture(scope="module")
def recipe_ba_problem():
    """The problem of the first BA run of the port's run_slam over 12
    frames of the 160 x 120 sweep (fx = fy = 153.5) in map mode
    (chip_smoke's "slam map 32768 hash"), built at 8 torch threads."""
    from chip_smoke import slam_configs
    from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.slam import system

    cam = PinholeCamera.from_K([153.5, 0, 80, 0, 153.5, 60, 0, 0, 1], width=160, height=120)
    gt = sweep_trajectory(n=60)
    frames = [render_textured_room(cam, gt[i], seed=i) for i in range(12)]
    grays = torch.from_numpy(np.stack([g for g, _ in frames]))
    depths = torch.from_numpy(np.stack([d for _, d in frames]))
    calls, real = [], system.bundle_adjust

    def record(problem, *args, **kwargs):
        calls.append((problem, args, kwargs))
        return real(problem, *args, **kwargs)

    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    system.bundle_adjust = record
    try:
        system.run_slam(cam, depths, grays, slam_configs()["slam map 32768 hash"])
    finally:
        system.bundle_adjust = real
        torch.set_num_threads(threads)
    assert calls, "no BA run in the first 12 frames"
    return calls[0]


@pytest.mark.parametrize("threads", [8, 1])
def test_bundle_adjust_stays_finite_on_the_map_mode_problem(recipe_ba_problem, threads):
    problem, args, kwargs = recipe_ba_problem
    assert all(x is None or bool(torch.isfinite(x.float()).all()) for x in problem)
    want = jb.bundle_adjust(jb.BAProblem(*(None if x is None else jnp.asarray(x.numpy()) for x in problem)),
                            *args, **kwargs)
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = tb.bundle_adjust(problem, *args, **kwargs)
    finally:
        torch.set_num_threads(saved)
    assert bool(torch.isfinite(got.poses_wc).all()) and bool(torch.isfinite(got.landmarks).all())
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-4)
    assert float(got.final_cost) < float(got.initial_cost)
