"""The port's rank mesh and distributed ICP (``perception_tpu_torch/
parallel/{mesh, icp_dist}.py``) on a gloo fleet of 4 ranks on the CPU,
against the JAX package's on 4 of the conftest's 8 virtual CPU devices,
both on the same numpy inputs (``tests/test_parallel.py``'s cases).

One fleet serves the file (a module fixture); its ranks run the cases of
``tests/torch_fleet_cases.py`` and return numpy results. Replicated
outputs are checked bit-identical across ranks inside the fleet
(``multihost.fetch_replicated`` raises otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops.normals import normals_knn
from perception_tpu.parallel.icp_dist import make_distributed_icp_step
from perception_tpu.parallel.mesh import frame_sharding, make_mesh
from perception_tpu_torch.parallel.icp_dist import make_distributed_icp_step as port_icp_step
from perception_tpu_torch.parallel.multihost import run_fleet

import torch_fleet_cases

RANKS = 4


def structured_cloud(rng, n):
    pts = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    third = n // 3
    pts[:third, 2] = 0.0
    pts[third:2 * third, 1] = 0.0
    pts[2 * third:, 0] = 0.0
    return pts


def icp_case(seed, B, N, M, scale, iterations, sample):
    """test_parallel.py's problems from numpy draws: frames of the target's
    first N points (``sample=False``) or of N points drawn per frame, moved
    by poses exp(normal * scale); the target normals from the JAX
    ``normals_knn`` (k=10)."""
    rng = np.random.default_rng(seed)
    target = structured_cloud(rng, M)
    tmask = np.ones(M, bool)
    normals = np.asarray(normals_knn(jnp.asarray(target), jnp.asarray(tmask), k=10)[0])
    Ts = np.asarray(jse3.se3_exp(jnp.asarray((rng.standard_normal((B, 6)) * scale).astype(np.float32))))
    sel = rng.integers(0, M, (B, N)) if sample else np.tile(np.arange(N), (B, 1))
    frames = np.stack([np.asarray(jse3.transform_points(jse3.inverse(jnp.asarray(Ts[b])), jnp.asarray(target[sel[b]])))
                       for b in range(B)])
    return dict(frames=frames.astype(np.float32), masks=np.ones((B, N), bool),
                init=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)), target=target, normals=normals, tmask=tmask,
                dp=2, sp=2, iterations=iterations), Ts


@pytest.fixture(scope="module")
def cases():
    match, _ = icp_case(3, B=4, N=512, M=1024, scale=0.02, iterations=5, sample=False)
    gt, Ts = icp_case(2, B=8, N=1024, M=2048, scale=np.array([0.03, 0.03, 0.03, 0.05, 0.05, 0.05]),
                      iterations=10, sample=True)
    results = run_fleet(torch_fleet_cases.run_cases, RANKS, ([("mesh_case", None), ("icp_case", [match, gt])],),
                        device="cpu")
    return {"match": match, "gt": gt, "Ts": Ts, "mesh": [r[0] for r in results], "icp": [r[1] for r in results]}


def assembled(icp_results, case_index):
    """The (B, 4, 4) transforms from the ranks' blocks (sp ranks hold equal copies)."""
    blocks = {}
    for r in icp_results:
        res = r[case_index]
        blocks[res["block"][0].start] = res["transforms"]
    return np.concatenate([blocks[k] for k in sorted(blocks)])


def test_mesh_shapes_blocks_and_errors(cases):
    for rank, m in enumerate(cases["mesh"]):
        d, s = divmod(rank, 2)
        assert m["shape"] == (2, 2) and m["names"] == ("dp", "sp") and m["coord"] == (d, s)
        assert m["block"] == (slice(2 * d, 2 * d + 2), slice(4 * s, 4 * s + 4))
        assert m["obs_block"] == (slice(3 * rank, 3 * rank + 3),)
        assert m["global"] == (4, 1) and m["sp_only"] == (1, 4)
        assert m["error"] == "dp*sp = 3*2 != 4 ranks"
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=2, devices=jax.devices()[:4])


def test_distributed_icp_matches_jax_mesh(cases):
    c = cases["match"]
    mesh = make_mesh(dp=2, sp=2, devices=jax.devices()[:RANKS])
    fs = frame_sharding(mesh)
    want = make_distributed_icp_step(mesh, iterations=c["iterations"])(
        jax.device_put(jnp.asarray(c["frames"]), fs), jax.device_put(jnp.asarray(c["masks"]), fs),
        jnp.asarray(c["init"]), jnp.asarray(c["target"]), jnp.asarray(c["normals"]), jnp.asarray(c["tmask"]))
    got = assembled(cases["icp"], 0)
    np.testing.assert_allclose(got, np.asarray(want.transforms), atol=2e-5)
    res = cases["icp"][0][0]
    assert int(res["num_corr"]) == int(want.num_corr)
    np.testing.assert_allclose(float(res["mean_residual"]), float(want.mean_residual), rtol=1e-3, atol=1e-7)
    for r in cases["icp"]:  # replicated diagnostics: the same bits on every rank
        assert r[0]["mean_residual"].tobytes() == res["mean_residual"].tobytes()
        assert r[0]["num_corr"] == res["num_corr"]
    # The port's single-rank run of the same step (mesh=None) agrees too.
    T = lambda k: torch.from_numpy(np.array(c[k]))
    one = port_icp_step(None, iterations=c["iterations"])(T("frames"), T("masks"), T("init"), T("target"),
                                                        T("normals"), T("tmask"))
    np.testing.assert_allclose(got, one.transforms.numpy(), atol=2e-5)


def test_distributed_icp_recovers_poses(cases):
    got = assembled(cases["icp"], 1)
    B, N = cases["gt"]["masks"].shape
    for b in range(B):
        err = jse3.se3_log(jnp.asarray(got[b]) @ jse3.inverse(jnp.asarray(cases["Ts"][b])))
        assert float(jnp.linalg.norm(err)) < 5e-3, f"frame {b}"
    res = cases["icp"][0][1]
    assert float(res["mean_residual"]) < 1e-3
    assert int(res["num_corr"]) == B * N
