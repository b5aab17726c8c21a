"""The port's bundle adjustment and pose-graph optimization against the
JAX package, on ``make_ba_problem`` and ``make_loop_graph`` of
``test_backend.py``.

The port solves the dense systems by LU with partial pivoting
(``solve_ex``) where the JAX package runs an unpivoted Gauss-Jordan, and
adds its segment sums in another order. Tolerances, as measured:

- ``bundle_adjust`` with the depth residual pinning the scale gauge (as
  the SLAM system runs it): poses within 3.1e-6, landmarks 9.6e-7, costs
  rtol 5.4e-6; held to atol 2e-5 and rtol 1e-4. Swapping the port's LU
  for a Gauss-Jordan like the JAX package's changes these by less than
  1e-5: the solver is not what differs.
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
