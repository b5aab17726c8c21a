"""The port's Euclidean clustering against the JAX package on the CPU.

Both modes (voxel adjacency, and ``refine=True``'s distance-checked
point edges) on the same numpy clouds: labels, sizes and
``num_clusters`` equal exactly; centroids within 1e-6 (both sum the
slots' points in index order on the CPU). Cases: Gaussian blobs of 512
and 2048 points with masked-out points, two components of equal size
(the tie goes to the lower root, as ``lax.top_k`` gives it), a pair of
blobs in corner-adjacent voxels but farther apart than the tolerance
(one cluster by voxels, two by distance), and more cluster slots than
points.
"""

import numpy as np
import pytest
import torch

from perception_tpu.ops import cluster as jcluster
from perception_tpu_torch.ops import cluster

torch.set_num_threads(2)


def blobs(n, seed):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-0.3, 0.3, (6, 3))
    pts = centres[rng.randint(0, 6, n)] + rng.randn(n, 3) * 0.015
    return pts.astype(np.float32), rng.rand(n) > 0.1


def equal_pair(seed=2):
    """Two 100-point blobs 0.5 m apart and a 40-point one between them."""
    rng = np.random.RandomState(seed)
    a = rng.randn(100, 3) * 0.01
    return np.concatenate([a + [0.25, 0, 0.8], a[:40] + [0, 0.2, 0.8], a + [-0.25, 0, 0.8]]).astype(np.float32), \
        np.ones(240, bool)


def bridged():
    """Two slabs in neighbouring 2 cm cells, 3.1 cm apart: x in [0, 4] mm
    (cell 250) and [35, 39] mm (cell 251)."""
    rng = np.random.RandomState(3)
    a = np.stack([rng.uniform(0.0, 0.004, 150), rng.uniform(0.3, 0.31, 150), rng.uniform(0.7, 0.71, 150)], 1)
    b = a + [0.035, 0.0, 0.0]
    return np.concatenate([a, b]).astype(np.float32), np.ones(300, bool)


CASES = {
    "blobs512": (lambda: blobs(512, 0), dict(min_size=10, max_clusters=8)),
    "blobs2048": (lambda: blobs(2048, 1), dict(min_size=40, max_clusters=4)),
    "equal_pair": (equal_pair, dict(min_size=30, max_clusters=8)),
    "bridged": (bridged, dict(min_size=10, max_clusters=8)),
    "few_points": (lambda: blobs(6, 5), dict(min_size=1, max_clusters=8)),
}


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_euclidean_cluster_matches(case, refine):
    make, kw = CASES[case]
    pts, mask = make()
    want = jcluster.euclidean_cluster(pts, mask, refine=refine, **kw)
    got = cluster.euclidean_cluster(torch.from_numpy(pts), torch.from_numpy(mask), refine=refine, **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert int(got.num_clusters) == int(want.num_clusters)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=1e-6, rtol=0)
    assert got.labels.dtype == torch.int32 and got.sizes.dtype == torch.int32
    if case == "bridged":
        assert int(got.num_clusters) == (2 if refine else 1)
    if case == "equal_pair":
        assert got.sizes[:2].tolist() == [100, 100]
        # The lower root takes slot 0: the lowest point index with refine,
        # the lowest voxel rank (cell ids grow with x) without.
        first, last = (0, 1) if refine else (1, 0)
        assert (int(got.labels[0]), int(got.labels[-1])) == (first, last)


def test_extract_and_gather_clusters():
    pts, mask = blobs(512, 0)
    got = cluster.euclidean_cluster(torch.from_numpy(pts), torch.from_numpy(mask), min_size=10, max_clusters=8)
    cpts, cm = cluster.gather_clusters(torch.from_numpy(pts), got.labels, 8, 200)
    for cid in range(8):
        want_pts, want_m = jcluster.extract_cluster(pts, np.asarray(got.labels.numpy()), cid, 200)
        one_pts, one_m = cluster.extract_cluster(torch.from_numpy(pts), got.labels, cid, 200)
        np.testing.assert_array_equal(one_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(one_pts.numpy(), np.asarray(want_pts))
        assert torch.equal(cpts[cid], one_pts) and torch.equal(cm[cid], one_m)
        assert int(cm[cid].sum()) == min(int(got.sizes[cid]), 200)
