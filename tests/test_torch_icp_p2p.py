"""The port's point-to-point ICP against the JAX package on the CPU.

Inputs come from ``tests/test_icp.py``'s ``make_pair`` (three planes, a
known twist) as numpy. Tolerances: ``_umeyama`` within 1e-5 (both solve
the same 3x3 SVD in float32 with other LAPACK orders); the ICP
transforms within 1e-4 and fitness within atol 1e-8 + rtol 1e-3; the
iteration counts and ``converged`` flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops import icp as jicp
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops import icp
from test_icp import make_pair

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_umeyama_matches(seed):
    rng = np.random.RandomState(seed)
    src = rng.randn(300, 3).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32))))
    tgt = (src @ R.T + rng.randn(3) + rng.randn(300, 3) * 0.01).astype(np.float32)
    w = (rng.rand(300) > 0.2).astype(np.float32)
    want = np.asarray(jicp._umeyama(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
    got = icp._umeyama(_t(src), _t(tgt), _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:3, :3], R, atol=1e-2)


def test_umeyama_planar_and_reflection():
    """A flat source (rank-2 H) and a mirrored target: the det fix keeps a
    rotation, as in the JAX package."""
    rng = np.random.RandomState(4)
    src = rng.randn(200, 3).astype(np.float32)
    src[:, 2] = 0.0
    mirrored = (src * np.array([1.0, 1.0, -1.0], np.float32) + 0.1).astype(np.float32)
    w = np.ones(200, np.float32)
    for tgt in (src + np.float32(0.05), mirrored):
        want = np.asarray(jicp._umeyama(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
        got = icp._umeyama(_t(src), _t(tgt), _t(w)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert abs(np.linalg.det(got[:3, :3]) - 1.0) < 1e-5


def check(res, jres):
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(jres.transform), atol=1e-4, rtol=0)
    np.testing.assert_allclose(res.fitness.numpy(), np.asarray(jres.fitness), atol=1e-8, rtol=1e-3)
    np.testing.assert_array_equal(res.num_corr.numpy(), np.asarray(jres.num_corr))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))


@pytest.mark.parametrize("seed,twist,iters,mcd", [
    (1, [0.02, -0.01, 0.03, 0.05, -0.04, 0.06], 60, 1.0e5),
    (2, [0.0, 0.01, -0.02, 0.0, 0.1, 0.0], 7, 1.0e5),     # stops at the cap
    (3, [0.01, 0.0, 0.0, 0.02, 0.0, -0.03], 60, 0.01),    # correspondence gate
])
def test_icp_point_to_point_matches(seed, twist, iters, mcd):
    src, sm, tgt, tm, _ = make_pair(jax.random.key(seed), twist)
    jres = jicp.icp_point_to_point(src, sm, tgt, tm, max_iterations=iters, max_correspondence_distance=mcd)
    res = icp.icp_point_to_point(*(_t(a) for a in (src, sm, tgt, tm)), max_iterations=iters,
                                 max_correspondence_distance=mcd)
    check(res, jres)
    assert res.transform.shape == (4, 4) and res.iterations.dtype == torch.int32


def test_icp_batched_matches():
    """Restarts from four yaw inits, one of them a masked-out lane; the
    lanes stop at different iterations."""
    src, sm, tgt, tm, T = make_pair(jax.random.key(5), [0.01, 0.02, 0.0, 0.0, 0.0, 0.4], n=600)
    yaws = np.array([0.0, 0.3, -0.3, 1.2], np.float32)
    inits = np.stack([np.asarray(jse3.se3_exp(jnp.asarray([0, 0, 0, 0, 0, y], jnp.float32))) for y in yaws])
    sources = np.broadcast_to(np.asarray(src), (4,) + src.shape).copy()
    masks = np.broadcast_to(np.asarray(sm), (4,) + sm.shape).copy()
    masks[3] = False
    jres = jicp.icp_batched(jnp.asarray(sources), jnp.asarray(masks), tgt, tm,
                            init_transforms=jnp.asarray(inits), max_iterations=60)
    res = icp.icp_batched(_t(sources), _t(masks), _t(tgt), _t(tm), init_transforms=_t(inits), max_iterations=60)
    check(res, jres)
    assert len(set(res.iterations.tolist())) > 1
    np.testing.assert_allclose(res.transform[0].numpy(), np.asarray(T), atol=1e-3)


def test_icp_point_to_point_stops_once_every_lane_is_done(monkeypatch):
    """The host check of done.all() ends the loop early; the result is that
    of the full trip count."""
    src, sm, tgt, tm, _ = make_pair(jax.random.key(1), [0.02, -0.01, 0.03, 0.05, -0.04, 0.06])
    args = [_t(a) for a in (src, sm, tgt, tm)]
    calls = []
    real = icp._umeyama
    monkeypatch.setattr(icp, "_umeyama", lambda *a: calls.append(1) or real(*a))
    every = icp.DONE_CHECK_EVERY
    early = icp.icp_point_to_point(*args, max_iterations=500)
    trips = len(calls)
    monkeypatch.setattr(icp, "DONE_CHECK_EVERY", 10 ** 6)
    full = icp.icp_point_to_point(*args, max_iterations=500)
    assert len(calls) == trips + 500
    assert trips < 500 and trips % every == 0
    assert trips - every < int(early.iterations) <= trips
    for a, b in zip(early, full):
        assert torch.equal(a, b)


def test_point_to_plane_with_one_target_per_row_matches_the_loop():
    """Batched targets (the tracker's per-slot templates) give what one
    call per target gives."""
    rng = np.random.RandomState(0)
    tgts = torch.from_numpy(rng.uniform(-0.1, 0.1, (3, 200, 3)).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.from_numpy(rng.randn(3, 200, 3).astype(np.float32)), dim=-1)
    tmask = torch.from_numpy(rng.rand(3, 200) > 0.1)
    src = (tgts[:, None, :150] + 0.002).expand(3, 2, 150, 3)
    smask = torch.ones(3, 2, 150, dtype=torch.bool)
    inits = se3.se3_exp(torch.from_numpy((rng.randn(3, 2, 6) * 0.01).astype(np.float32)))
    res = icp.icp_point_to_plane(src, smask, tgts[:, None], nrm[:, None], tmask[:, None], inits, max_iterations=5)
    for k in range(3):
        one = icp.icp_point_to_plane(src[k], smask[k], tgts[k], nrm[k], tmask[k], inits[k], max_iterations=5)
        for a, b in zip(res, one):
            torch.testing.assert_close(a[k], b, atol=1e-6, rtol=1e-6)
