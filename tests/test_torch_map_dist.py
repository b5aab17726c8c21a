"""The port's map-block-partitioned odometry GN
(``perception_tpu_torch/parallel/map_dist.py``) on a gloo fleet of 4 ranks
on the CPU, against the JAX package's ``make_map_sharded_gn`` on a 1-D
"mp" mesh of 4 of the conftest's virtual CPU devices, on the same numpy
inputs (``tests/test_map_dist.py``'s scenes and bounds): one step, a
4-frame trajectory, and a map whose second half repeats its first, so
that every nearest neighbour ties across two ranks and its weight is
split between them. One fleet serves the file; replicated outputs are
checked bit-identical across ranks inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops.normals import normals_knn
from perception_tpu.parallel.map_dist import make_map_sharded_gn, map_sharding
from perception_tpu_torch.parallel.multihost import run_fleet

import torch_fleet_cases

RANKS = 4


def scene(seed, m=4096, repeat=False):
    """Three orthogonal planes of m points (``repeat``: the first m/2 twice),
    their JAX ``normals_knn`` (k=8) and mask."""
    rng = np.random.default_rng(seed)
    half = m // 2 if repeat else m
    tgt = rng.uniform(-0.5, 0.5, (half, 3)).astype(np.float32)
    tgt[: half // 3, 2] = 0.0
    tgt[half // 3: 2 * half // 3, 1] = 0.0
    tgt[2 * half // 3:, 0] = 0.0
    if repeat:
        tgt = np.concatenate([tgt, tgt])
    mask = np.ones(m, bool)
    nrm = np.asarray(normals_knn(jnp.asarray(tgt), jnp.asarray(mask), k=8)[0])
    return tgt, nrm, mask, rng


def frames(tgt, rng, twists, n=1024):
    """Source clouds of n map points moved by the inverse of each twist's pose."""
    out, gts = [], []
    for tw in twists:
        T_gt = np.asarray(jse3.se3_exp(jnp.asarray(tw, jnp.float32)))
        sel = rng.integers(0, tgt.shape[0], n)
        out.append(np.asarray(jse3.transform_points(jse3.inverse(jnp.asarray(T_gt)), jnp.asarray(tgt[sel]))))
        gts.append(T_gt)
    return np.stack(out), np.stack(gts)


def build_cases():
    one_map = scene(0)
    src1, gt1 = frames(one_map[0], one_map[3], [one_map[3].standard_normal(6) * 0.02])
    traj_map = scene(1)
    src4, gt4 = frames(traj_map[0], traj_map[3],
                       [[0.02 * (f + 1), 0.01 * f, 0.0, 0.0, 0.01 * f, 0.0] for f in range(4)])
    tie_map = scene(2, repeat=True)
    srct, gtt = frames(tie_map[0], tie_map[3], [tie_map[3].standard_normal(6) * 0.02])
    mk = lambda mp, src, gt, it: dict(map=mp[0], normals=mp[1], mask=mp[2], src=src, gt=gt, iterations=it,
                                      T0=np.eye(4, dtype=np.float32))
    return {"one": mk(one_map, src1, gt1, 8), "trajectory": mk(traj_map, src4, gt4, 6), "tie": mk(tie_map, srct, gtt, 8)}


@pytest.fixture(scope="module")
def fleet():
    cases = build_cases()
    results = run_fleet(torch_fleet_cases.run_cases, RANKS, ([("map_case", list(cases.values()))],), device="cpu")
    for r in results[1:]:
        for a, b in zip(r[0], results[0][0]):
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    return cases, dict(zip(cases, results[0][0]))


def jax_trajectory(c):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:RANKS]), ("mp",))
    ms = map_sharding(mesh)
    step = make_map_sharded_gn(mesh, iterations=c["iterations"])
    args = [jax.device_put(jnp.asarray(c[k]), ms) for k in ("map", "normals", "mask")]
    T, out = jnp.asarray(c["T0"]), []
    for src in c["src"]:
        res = step(*args, jnp.asarray(src), jnp.ones(src.shape[0], bool), T)
        T = res.transform
        out.append(res)
    return out


@pytest.mark.parametrize("name", ["one", "tie"])
def test_map_sharded_step_matches_jax(fleet, name):
    cases, got = fleet
    c, g = cases[name], got[name]
    (want,) = jax_trajectory(c)
    np.testing.assert_allclose(g["transform"][0], np.asarray(want.transform), atol=2e-4)
    np.testing.assert_allclose(g["transform"][0], c["gt"][0], atol=5e-3)
    assert float(g["fitness"][0]) < 1e-4
    assert int(g["num_corr"][0]) == int(want.num_corr) == c["src"].shape[1]


def test_map_sharded_trajectory_matches_jax(fleet):
    cases, got = fleet
    c, g = cases["trajectory"], got["trajectory"]
    for f, want in enumerate(jax_trajectory(c)):
        np.testing.assert_allclose(g["transform"][f], np.asarray(want.transform), atol=5e-4)
