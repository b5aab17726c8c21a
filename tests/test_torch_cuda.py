"""The port on a CUDA card: the fused RANSAC-scoring kernel and the cuboid
pipeline against their CPU/plain versions. Every test skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
the card is, which has no JAX; the tests' conftest imports jax, so run it
there with ``--noconftest`` (see README.md).

Tolerances: the kernel's counts equal the plain version's exactly (both
round each multiply and add separately). Pipeline on the card against
the CPU with the same RANSAC triplets: same acceptance, translation
within 1 mm, fitness within rtol 5e-2 — CUDA's ``index_add_`` adds with
atomics, so a voxel centroid may move by an ulp and one point may cross
the RANSAC threshold.
"""

import numpy as np
import pytest
import torch

from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.cuboid import (
    CuboidConfig,
    cuboid_pipeline_batch,
    decimate,
    ransac_input,
    template_features,
)
from perception_tpu_torch.ops.kernels.ransac_score import ransac_score, ransac_score_reference
from perception_tpu_torch.ops.ransac import _sample_indices


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_case(seed, b, n, k):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    normals = rng.randn(b, k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    hyp = np.concatenate([normals, rng.randn(b, k, 1).astype(np.float32) * 0.5], -1)
    return pts, mask, hyp


@pytest.mark.parametrize("b,n,k", [(1, 8192, 1024), (2, 777, 100), (3, 1, 1)])
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, k):
    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(b, b, n, k))
    before = ransac_score.launches
    got = ransac_score(pts, mask, hyp, 0.05)
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    assert torch.equal(got, ransac_score_reference(pts, mask, hyp, 0.05))


def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(0, 1, 64, 8))
    with pytest.raises(TypeError):
        ransac_score(pts.double(), mask, hyp, 0.05)
    with pytest.raises(ValueError):
        ransac_score(pts.transpose(1, 2).contiguous(), mask, hyp, 0.05)
    with pytest.raises(ValueError):
        ransac_score(pts, mask.cpu(), hyp, 0.05)


def test_cuda_pipeline_matches_cpu_with_same_triplets(cuda_device):
    cfg = CuboidConfig()
    camera = PinholeCamera.d435_depth()
    tnp = benchmark_template()
    depths, gts = bench_frames(camera, (1, 5))
    depths = torch.from_numpy(depths)
    d, cam2 = decimate(depths, camera, cfg.depth_stride)
    _, dm = ransac_input(*cam2.backproject_depth(d), cfg)
    idx = _sample_indices(torch.Generator().manual_seed(3), dm, cfg.ransac_hypotheses)
    res = {}
    for dev in ("cpu", cuda_device):
        t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=dev)
        out = cuboid_pipeline_batch(depths.to(dev), camera, t, tm, None, cfg,
                                    template_normals=tn, indices=idx)
        res[str(dev)] = type(out)(*(x.cpu() for x in out))
    c, g = res["cpu"], res[str(cuda_device)]
    assert torch.equal(c.accepted, g.accepted) and bool(g.accepted.all())
    assert float((c.pose[:, :3, 3] - g.pose[:, :3, 3]).norm(dim=-1).max()) <= 1e-3
    np.testing.assert_allclose(g.fitness.numpy(), c.fitness.numpy(), rtol=5e-2)
    err = np.linalg.norm(g.pose[:, :3, 3].numpy() - gts[:, :3, 3], axis=-1)
    assert np.all(err <= 0.02)
