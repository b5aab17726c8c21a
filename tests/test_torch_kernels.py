"""The port's fused RANSAC-scoring kernel (K1) against the JAX package.

On the CPU the wrapper takes its plain version, which must count exactly
what the Pallas kernel (interpret mode) and the jnp oracle count: the
counts are integers, and both sides round every multiply and add in
float32, so no tolerance is allowed, also on ``chip_smoke``'s edge
inputs: points exactly at +-tau from axis-aligned planes, one ulp past
it, -0.0, NaN and +-inf coordinates, valid and masked. The kernel itself
is held against the plain version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.ops import ransac as R
from perception_tpu.ops.pallas.ransac_score import ransac_score_pallas
from perception_tpu_torch.ops.kernels import build
from perception_tpu_torch.ops.kernels.ransac_score import (
    ransac_score,
    ransac_score_reference,
)

torch.set_num_threads(2)


def random_case(seed, n, k):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    mask = rng.rand(n) > 0.2
    normals = rng.randn(k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    d = rng.randn(k).astype(np.float32) * 0.5
    return pts, mask, normals, d


def port_score(pts, mask, normals, d, tau):
    hyp = np.concatenate([normals, d[:, None]], axis=1)
    got = ransac_score(
        torch.from_numpy(pts)[None], torch.from_numpy(mask)[None],
        torch.from_numpy(hyp)[None], tau,
    )
    assert got.dtype == torch.int32 and got.shape == (1, len(d))
    return got[0].numpy()


@pytest.mark.parametrize(
    "seed,n,k,tau,tiles",
    [
        (0, 1000, 64, 0.1, (256, 64)),     # small
        (1, 777, 100, 0.05, (256, 64)),    # N and K not multiples of the tiles
        (2, 2000, 128, 0.08, (512, 128)),  # the jnp-oracle case
    ],
)
def test_reference_matches_pallas_and_oracle(seed, n, k, tau, tiles):
    pts, mask, normals, d = random_case(seed, n, k)
    args = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(d), tau)
    pallas = np.asarray(ransac_score_pallas(*args, tile_n=tiles[0], tile_k=tiles[1]))
    oracle = np.asarray(R._score(*args))
    got = port_score(pts, mask, normals, d, tau)
    np.testing.assert_array_equal(got, pallas.astype(np.int32))
    np.testing.assert_array_equal(got, oracle)


def test_all_masked_scores_zero():
    pts, _, normals, d = random_case(3, 500, 32)
    mask = np.zeros(500, bool)
    pallas = ransac_score_pallas(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(d), 0.1,
        tile_n=256, tile_k=32,
    )
    got = port_score(pts, mask, normals, d, 0.1)
    np.testing.assert_array_equal(got, np.asarray(pallas).astype(np.int32))
    np.testing.assert_array_equal(got, np.zeros(32, np.int32))


def test_batch_of_two_matches_pallas_per_frame():
    cases = [random_case(s, 3000, 200) for s in (4, 5)]
    pts = np.stack([c[0] for c in cases])
    mask = np.stack([c[1] for c in cases])
    hyp = np.stack([np.concatenate([c[2], c[3][:, None]], 1) for c in cases])
    got = ransac_score(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(hyp), 0.07)
    for b, (p, m, nrm, d) in enumerate(cases):
        pallas = ransac_score_pallas(
            jnp.asarray(p), jnp.asarray(m), jnp.asarray(nrm), jnp.asarray(d), 0.07,
        )
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(pallas).astype(np.int32))


@pytest.mark.parametrize("b,n,k", [(1, 777, 100), (3, 777, 100), (1, 8192, 1023)])
def test_reference_matches_pallas_on_edge_inputs(b, n, k):
    from chip_smoke import TAU, k1_edge_inputs

    pts, mask, hyp = k1_edge_inputs(b, n, k, "cpu", seed=b + n + k)
    got = ransac_score(pts, mask, hyp, TAU)
    p, m, h = pts.numpy(), mask.numpy(), hyp.numpy()
    tau = np.float32(TAU)
    # The inputs hold what they promise: ties at +-tau, valid and masked
    # NaN and +-inf points, -0.0.
    assert (m & (np.abs(p[..., 0]) == tau)).any() and (~m & (np.abs(p[..., 0]) == tau)).any()
    for bad in (np.isnan(p).any(-1), np.isposinf(p).any(-1), np.isneginf(p).any(-1)):
        assert (m & bad).any() and (~m & bad).any()
    assert (np.signbit(p) & (p == 0)).any()
    # Plane x = 0 counts the valid points with |x| <= tau, ties included.
    assert (got[:, 0].numpy() == (m & (np.abs(p[..., 0]) <= tau) & np.isfinite(p).all(-1)).sum(-1)).all()
    for f in range(b):
        pallas = ransac_score_pallas(jnp.asarray(p[f]), jnp.asarray(m[f]), jnp.asarray(h[f, :, :3]),
                                     jnp.asarray(h[f, :, 3]), TAU)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(pallas).astype(np.int32))


def test_cpu_dispatch_takes_the_plain_version_and_counts_no_launch():
    pts, mask, normals, d = random_case(6, 300, 16)
    before = ransac_score.launches
    port_score(pts, mask, normals, d, 0.1)
    assert ransac_score.launches == before


def test_reference_chunking_is_invisible():
    # More points than one chunk of the plain version's loop.
    pts, mask, normals, d = random_case(7, 5000, 40)
    hyp = torch.from_numpy(np.concatenate([normals, d[:, None]], 1))[None]
    got = ransac_score_reference(torch.from_numpy(pts)[None], torch.from_numpy(mask)[None], hyp, 0.2)
    oracle = R._score(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(normals), jnp.asarray(d), 0.2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(oracle))


def test_library_path_is_keyed_on_source_and_flags(monkeypatch):
    path = build.library_path("ransac_score")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libransac_score-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("ransac_score") != path


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "_NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
