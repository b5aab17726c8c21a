"""The port's point ops and nearest-neighbor search against the JAX package.

Tolerances: passthrough, compact and compact_prefix are exact (masks and
gathered rows); voxel_downsample keeps equal masks and centroids within
atol 1e-6 (the segment sums add in another order); the blob filter's
mask is exact. nearest_neighbor's d2 agrees within 1e-6 + 1e-5 * d2 and
its indices agree except where the two sides' d2 of the two candidates
lie within 1e-6 (a matmul-rounding tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.ops import nn as jnn
from perception_tpu.ops import points as JP
from perception_tpu_torch.bench import scene
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models import cuboid
from perception_tpu_torch.ops import nn
from perception_tpu_torch.ops import points as P

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def bench_cloud(seed=0):
    """A bench frame, decimated and backprojected as the pipeline does."""
    cam = PinholeCamera.d435_depth()
    depth = scene.render_depth_tabletop(cam, scene.bench_twist(seed), seed=seed)
    d, cam2 = cuboid.decimate(torch.from_numpy(depth), cam, 2)
    pts, mask = cam2.backproject_depth(d)
    return pts.numpy(), mask.numpy()


def random_cloud(seed, n, frac=0.7):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * [0.4, 0.3, 0.9] - [0.2, 0.15, 0.0]).astype(np.float32)
    return pts, rng.rand(n) < frac


def passthrough_both(pts, mask):
    m = P.passthrough(_t(pts), _t(mask), 2, 0.0, 0.9)
    m = P.passthrough(_t(pts), m, 0, -0.2, 0.2)
    jm = JP.passthrough(jnp.asarray(pts), jnp.asarray(mask), 2, 0.0, 0.9)
    jm = JP.passthrough(jnp.asarray(pts), jm, 0, -0.2, 0.2)
    return m.numpy(), np.asarray(jm)


def test_passthrough_and_apply_mask_exact():
    pts, mask = bench_cloud()
    m, jm = passthrough_both(pts, mask)
    np.testing.assert_array_equal(m, jm)
    assert 0 < m.sum() < mask.sum()
    np.testing.assert_array_equal(
        P.apply_mask(_t(pts), _t(m)).numpy(), np.asarray(JP.apply_mask(jnp.asarray(pts), jnp.asarray(m)))
    )


@pytest.mark.parametrize("capacity", [16384, 4096, 50000])  # under, over, pad
def test_compact_exact(capacity):
    pts, mask = bench_cloud(1)
    m, _ = passthrough_both(pts, mask)
    got_p, got_m = P.compact(_t(pts), _t(m), capacity)
    want_p, want_m = JP.compact(jnp.asarray(pts), jnp.asarray(m), capacity)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("n_valid,capacity", [(3000, 8192), (6000, 4096), (0, 64)])
def test_compact_prefix_exact(n_valid, capacity):
    pts, _ = random_cloud(2, 8192)
    mask = np.arange(8192) < n_valid
    got_p, got_m = P.compact_prefix(_t(pts), _t(mask), capacity)
    want_p, want_m = JP.compact_prefix(jnp.asarray(pts), jnp.asarray(mask), capacity)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("source", ["bench", "random"])
def test_voxel_downsample_matches(source):
    if source == "bench":
        pts, mask = bench_cloud(2)
        m, _ = passthrough_both(pts, mask)
        pts, mask = (np.asarray(a) for a in JP.compact(jnp.asarray(pts), jnp.asarray(m), 16384))
    else:
        pts, mask = random_cloud(3, 5000)
    got_p, got_m = P.voxel_downsample(_t(pts), _t(mask), 0.005)
    want_p, want_m = JP.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.005)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_m.sum() > 100
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6, rtol=0)


def test_voxel_downsample_with_attrs_and_weights_matches():
    pts, mask = random_cloud(4, 3000)
    rng = np.random.RandomState(5)
    attrs = rng.randn(3000, 2).astype(np.float32)
    weights = rng.rand(3000).astype(np.float32)
    got = P.voxel_downsample_with_attrs(_t(pts), _t(mask), _t(attrs), 0.02, weights=_t(weights))
    want = JP.voxel_downsample_with_attrs(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(attrs), 0.02, weights=jnp.asarray(weights)
    )
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)


def test_voxel_ids_and_centroid_match():
    pts, mask = random_cloud(6, 2000)
    origin = np.array([-0.3, -0.2, -0.1], np.float32)
    got = P.voxel_ids(_t(pts), _t(origin), 0.01, (64, 64, 128))
    want = JP.voxel_ids(jnp.asarray(pts), jnp.asarray(origin), 0.01, (64, 64, 128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        P.centroid(_t(pts), _t(mask)).numpy(),
        np.asarray(JP.centroid(jnp.asarray(pts), jnp.asarray(mask))), atol=1e-6, rtol=0,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_dominant_blob_filter_matches(seed):
    rng = np.random.RandomState(seed)
    blob = rng.randn(600, 3).astype(np.float32) * 0.03 + [0.05, 0.03, 0.8]
    clutter = rng.rand(424, 3).astype(np.float32) * [0.4, 0.3, 0.1] + [-0.2, -0.15, 0.75]
    pts = np.concatenate([blob, clutter]).astype(np.float32)
    mask = rng.rand(1024) < 0.9
    got = P.dominant_blob_filter(_t(pts), _t(mask), radius=0.13)
    want = JP.dominant_blob_filter(jnp.asarray(pts), jnp.asarray(mask), radius=0.13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize("nq,nr,tile", [(1024, 1280, 4096), (500, 3000, 1024), (300, 77, 4096)])
def test_nearest_neighbor_matches(nq, nr, tile):
    rng = np.random.RandomState(nq)
    ref = (rng.rand(nr, 3) * 0.3).astype(np.float32)
    ref_mask = rng.rand(nr) < 0.85
    query = (rng.rand(nq, 3) * 0.3 + 0.01).astype(np.float32)
    idx, d2 = nn.nearest_neighbor(_t(query), _t(ref), _t(ref_mask), tile=tile)
    jidx, jd2 = jnn.nearest_neighbor(jnp.asarray(query), jnp.asarray(ref), jnp.asarray(ref_mask), tile=tile)
    idx, d2, jidx, jd2 = idx.numpy(), d2.numpy(), np.asarray(jidx), np.asarray(jd2)
    np.testing.assert_allclose(d2, jd2, atol=1e-6, rtol=1e-5)
    assert ref_mask[idx].all()
    differ = idx != jidx
    # A differing index must be a tie: both candidates equally near.
    exact = lambda i: ((query - ref[i]) ** 2).sum(-1)  # noqa: E731
    assert np.all(np.abs(exact(idx)[differ] - exact(jidx)[differ]) < 1e-6)


def test_nearest_neighbor_batched_queries():
    rng = np.random.RandomState(9)
    ref = rng.rand(200, 3).astype(np.float32)
    query = rng.rand(3, 4, 50, 3).astype(np.float32)
    idx, d2 = nn.nearest_neighbor(_t(query), _t(ref), torch.ones(200, dtype=torch.bool))
    assert idx.shape == d2.shape == (3, 4, 50)
    for a in range(3):
        i1, d1 = nn.nearest_neighbor(_t(query[a, 2]), _t(ref), torch.ones(200, dtype=torch.bool))
        np.testing.assert_array_equal(idx[a, 2].numpy(), i1.numpy())
        np.testing.assert_array_equal(d2[a, 2].numpy(), d1.numpy())


@pytest.mark.parametrize("capacity,frac", [(300, 0.7), (2000, 0.5), (500, 0.0)])
def test_compact_with_attrs_exact(capacity, frac):
    pts, mask = random_cloud(11, 1500, frac)
    attrs = np.random.RandomState(12).randn(1500, 3).astype(np.float32)
    got = P.compact_with_attrs(_t(pts), _t(mask), _t(attrs), capacity)
    want = JP.compact_with_attrs(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(attrs), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("frac", [0.6, 0.0])
def test_bounds_exact(frac):
    pts, mask = random_cloud(13, 800, frac)
    for g, w in zip(P.bounds(_t(pts), _t(mask)), JP.bounds(jnp.asarray(pts), jnp.asarray(mask))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
