"""The port's fused Gauss-Newton ICP system (K2) against the JAX package.

On the CPU the wrapper takes its plain version. Held against the Pallas
kernel (interpret mode, at the shapes of ``test_pallas_icp_gn.py``) and
against both packages' gather oracles. Tolerances: M within rtol/atol
1e-4 and the gated d2 sum within rtol 1e-3, atol 1e-5, as the JAX tests
hold the Pallas kernel to its oracle (the sums run in another order and
the two distance formulas round differently); gate counts exact. The
packed operands are equal, |t|^2 within one float32 ulp (XLA may fuse its
multiply-adds). The kernel itself is held against the plain version on
the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.ops.pallas import icp_gn as jgn
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops.kernels import icp_gn as gn

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def case(seed=0, R=2, N=300, M=256):
    rng = np.random.RandomState(seed)
    src = rng.randn(R, N, 3).astype(np.float32) * 0.3
    smask = rng.rand(R, N) > 0.1
    tgt = rng.randn(M, 3).astype(np.float32) * 0.3
    tmask = rng.rand(M) > 0.1
    nrm = rng.randn(M, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return src, smask, tgt, nrm, tmask


def both(args):
    return tuple(jnp.asarray(a) for a in args), tuple(torch.from_numpy(a) for a in args)


@pytest.mark.parametrize(
    "seed,R,N,M,mcd,huber",
    [
        (0, 2, 300, 256, 0.5, 0.02),   # test_matches_oracle
        (1, 3, 217, 100, 0.3, 0.05),   # test_unaligned_sizes
        (3, 2, 200, 128, 0.5, 0.02),   # test_stats_match_oracle
    ],
)
def test_plain_version_matches_pallas_and_oracles(seed, R, N, M, mcd, huber):
    jargs, targs = both(case(seed, R, N, M))
    jM, js = jgn.gn_system_pallas(*jargs, mcd, huber, block=128, return_stats=True)
    oM, os_ = jgn.gn_system_oracle(*jargs, mcd, huber, return_stats=True)
    tM, ts = gn.gn_system(*targs, mcd, huber, block=128, return_stats=True)
    pM, ps = gn.gn_system_oracle(*targs, mcd, huber, return_stats=True)
    assert tM.shape == (R, 8, 8) and ts.shape == (R, 2) and tM.dtype == torch.float32
    for M_, s_ in ((jM, js), (oM, os_)):
        np.testing.assert_allclose(tM.numpy(), np.asarray(M_), **TOL)
        np.testing.assert_array_equal(ts[:, 0].numpy(), np.asarray(s_[:, 0]))
        np.testing.assert_allclose(ts[:, 1].numpy(), np.asarray(s_[:, 1]), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(pM.numpy(), np.asarray(oM), **TOL)
    np.testing.assert_array_equal(ps[:, 0].numpy(), np.asarray(os_[:, 0]))


def test_pack_matches_jax():
    src, smask, tgt, nrm, tmask = case(4, R=2, N=300, M=1100)
    s8 = gn.pack_source(torch.from_numpy(src), torch.from_numpy(smask), block=128)
    js8 = jgn.pack_source(jnp.asarray(src), jnp.asarray(smask), block=128)
    np.testing.assert_array_equal(s8.numpy(), np.asarray(js8))
    assert s8.shape == (2, 384, 8)
    tgtd, tn = gn.pack_target(*(torch.from_numpy(a) for a in (tgt, nrm, tmask)))
    jtgtd, jtn = jgn.pack_target(jnp.asarray(tgt), jnp.asarray(nrm), jnp.asarray(tmask))
    assert tgtd.shape == tn.shape == (2048, 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))
    np.testing.assert_allclose(tgtd.numpy(), np.asarray(jtgtd), rtol=1.2e-7, atol=0)


def test_posed_system_matches_pallas():
    """Non-identity poses ride in the 16 scalars built from Ts."""
    src, smask, tgt, nrm, tmask = case(5, R=2, N=256, M=300)
    xi = np.array([[0.02, -0.01, 0.03, 0.05, -0.02, 0.04], [0.0, 0.01, 0.0, 0.0, 0.1, 0.0]], np.float32)
    Ts = se3.se3_exp(torch.from_numpy(xi))
    jTs = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(Ts.numpy(), np.asarray(jTs), atol=1e-6)
    src8 = gn.pack_source(torch.from_numpy(src), torch.from_numpy(smask), block=128)
    tgtd, tn = gn.pack_target(*(torch.from_numpy(a) for a in (tgt, nrm, tmask)))
    M, s = gn.gn_system_packed(src8, tgtd, tn, Ts, 0.4, 0.03, return_stats=True)
    jM, js = jgn.gn_system_packed(
        jnp.asarray(src8.numpy()), jnp.asarray(tgtd.numpy()), jnp.asarray(tn.numpy()),
        jnp.asarray(Ts.numpy()), 0.4, 0.03, block=128, return_stats=True,
    )
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), **TOL)
    np.testing.assert_array_equal(s[:, 0].numpy(), np.asarray(js[:, 0]))
    # And against the gather oracle on the transformed source.
    src_t = se3.transform_points(Ts, torch.from_numpy(src))
    oM = gn.gn_system_oracle(src_t, torch.from_numpy(smask), *(torch.from_numpy(a) for a in (tgt, nrm, tmask)),
                             0.4, 0.03)
    np.testing.assert_allclose(M.numpy(), oM.numpy(), **TOL)


def test_gate_excludes_far_points():
    src = torch.tensor([[[0.0, 0, 0], [5.0, 5, 5]]])
    tgt = torch.tensor([[0.01, 0, 0]])
    M = gn.gn_system(src, torch.ones(1, 2, dtype=torch.bool), tgt, torch.tensor([[1.0, 0, 0]]),
                     torch.ones(1, dtype=torch.bool), 0.1, 0.02, block=128)
    assert abs(float(M[0, 7, 7]) - 1.0) < 1e-5


def test_all_masked_source_gives_zero_system():
    src, smask, tgt, nrm, tmask = case(6, R=1, N=100, M=64)
    M, s = gn.gn_system(torch.from_numpy(src), torch.zeros(1, 100, dtype=torch.bool),
                        *(torch.from_numpy(a) for a in (tgt, nrm, tmask)), 0.5, 0.02, return_stats=True)
    assert not M.any() and not s.any()


def test_system_drives_gn_to_convergence():
    rng = np.random.RandomState(2)
    tgt = rng.uniform(-0.3, 0.3, (512, 3)).astype(np.float32)
    tgt[:170, 2] = 0.0
    tgt[170:340, 1] = 0.0
    tgt[340:, 0] = 0.0
    nrm = np.zeros_like(tgt)
    nrm[:170] = (0, 0, 1)
    nrm[170:340] = (0, 1, 0)
    nrm[340:] = (1, 0, 0)
    T_true = se3.se3_exp(torch.tensor([0.03, -0.02, 0.04, 0.05, -0.04, 0.06]))
    src = se3.transform_points(se3.inverse(T_true), torch.from_numpy(tgt))
    src8 = gn.pack_source(src[None], torch.ones(1, 512, dtype=torch.bool), block=128)
    tgtd, tn = gn.pack_target(torch.from_numpy(tgt), torch.from_numpy(nrm), torch.ones(512, dtype=torch.bool))
    T = torch.eye(4)
    for _ in range(10):
        M = gn.gn_system_packed(src8, tgtd, tn, T[None], 0.5, 0.05)[0]
        xi = torch.linalg.solve(M[:6, :6] + 1e-6 * torch.eye(6), -M[:6, 6])
        T = se3.se3_exp(xi) @ T
    np.testing.assert_allclose(T.numpy(), T_true.numpy(), atol=2e-3)


def test_reference_chunking_is_invisible(monkeypatch):
    args = tuple(torch.from_numpy(a) for a in case(7, R=2, N=256, M=2000))
    src8 = gn.pack_source(args[0], args[1], block=128)
    tgtd, tn = gn.pack_target(*args[2:])
    Ts = torch.eye(4).expand(2, 4, 4)
    want = gn.gn_system_reference(src8, tgtd, tn, Ts, 0.5, 0.02)
    monkeypatch.setattr(gn, "_REF_ELEMS", 2 * 256 * 100)  # 100-row target chunks
    got = gn.gn_system_reference(src8, tgtd, tn, Ts, 0.5, 0.02)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_dispatch_counts_no_launch_and_rejects_empty_target():
    args = tuple(torch.from_numpy(a) for a in case(8, R=1, N=64, M=32))
    before = gn.gn_system_packed.launches
    gn.gn_system(*args, 0.5, 0.02)
    assert gn.gn_system_packed.launches == before
    with pytest.raises(ValueError, match="empty"):
        gn.gn_system_packed(gn.pack_source(args[0], args[1]), torch.zeros(0, 8), torch.zeros(0, 8),
                            torch.eye(4)[None], 0.5, 0.02)
