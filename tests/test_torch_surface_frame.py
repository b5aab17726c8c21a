"""The port's ``estimate_surface_frame`` against the JAX package's, on
``tests/test_models.py``'s tabletop scene and on a 640x480 bench frame.

Both sides get the JAX package's ground-plane output (the box cloud, its
mask and the ground normal) and the same RANSAC triplets: the port takes
the rows that ``jax.random.split(key, 3)`` draws for the three fits
(``ransac._sample_indices`` on each fit's mask). The JAX side scores
through its Pallas kernel in interpret mode, as ``test_models.py`` runs
it on the CPU; the port through K1's plain version.

Tolerances: inlier counts and the face order exact; face normals, the
pose and the validity within 1e-5 (the plane refits' eigh and the
centroid's float sums, LAPACK against XLA).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.models import cuboid as jcuboid
from perception_tpu.models.surface_frame import estimate_surface_frame as jestimate
from perception_tpu.ops import ransac as jransac
from perception_tpu_torch.bench import scene
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.surface_frame import estimate_surface_frame
from perception_tpu_torch.ops.kernels import ransac_score as k1
from test_models import tabletop_scene

torch.set_num_threads(2)


def jax_fit_indices(dpts, box_mask, gn, key, num=512, threshold=0.008, eps_angle=0.1):
    """The three fits' triplets as the JAX ``estimate_surface_frame`` draws them."""
    keys = jax.random.split(key, 3)
    m, idx = box_mask, []
    for k, model in zip(keys, ("perpendicular", "parallel", "parallel")):
        idx.append(np.asarray(jransac._sample_indices(k, m, num)))
        fit = jransac.ransac_plane(dpts, m, k, threshold=threshold, num_hypotheses=num, model=model,
                                   axis=gn, eps_angle=eps_angle)
        m = m & ~fit.inliers
    return idx


def tabletop_case():
    pts, mask, _, gts = tabletop_scene()
    fit, dpts, box_mask = jcuboid.segment_ground_plane(pts, mask, jax.random.key(0))
    return dpts, box_mask, fit.coefficients[:3], jax.random.key(5), gts[0][:3, 3]


def bench_case():
    jcam = JCamera.d435_depth()
    depth, gts = scene.bench_frames(PinholeCamera.d435_depth(), (2,))
    o, s = 1, 2
    d = jnp.asarray(depth[0])[o::s, o::s]
    jcam = dataclasses.replace(jcam, fx=jcam.fx / s, fy=jcam.fy / s, cx=(jcam.cx - o) / s,
                               cy=(jcam.cy - o) / s, width=d.shape[1], height=d.shape[0])
    pts, mask = jcam.backproject_depth(d)
    fit, dpts, box_mask = jcuboid.segment_ground_plane(pts, mask, jax.random.key(1))
    return dpts, box_mask, fit.coefficients[:3], jax.random.key(9), gts[0][:3, 3]


@pytest.fixture(scope="module", params=["tabletop", "bench"])
def case(request):
    dpts, box_mask, gn, key, center = tabletop_case() if request.param == "tabletop" else bench_case()
    want = jestimate(dpts, box_mask, gn, key)
    idx = jax_fit_indices(dpts, box_mask, gn, key)
    return dict(name=request.param, dpts=np.asarray(dpts), mask=np.asarray(box_mask), gn=np.asarray(gn),
                idx=idx, want=want, center=center)


def test_surface_frame_matches(case):
    k1.ransac_score.launches = 0
    got = estimate_surface_frame(torch.from_numpy(case["dpts"]), torch.from_numpy(case["mask"]),
                                 torch.from_numpy(case["gn"]), indices=[torch.from_numpy(i) for i in case["idx"]])
    want = case["want"]
    assert k1.ransac_score.launches == 0  # CPU tensors take the plain version
    np.testing.assert_array_equal(got.inlier_counts.numpy(), np.asarray(want.inlier_counts))
    assert got.inlier_counts.dtype == torch.int32
    assert bool(got.valid) == bool(want.valid)
    np.testing.assert_allclose(got.face_normals.numpy(), np.asarray(want.face_normals), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0, atol=1e-5)


def test_surface_frame_gates(case):
    got = estimate_surface_frame(torch.from_numpy(case["dpts"]), torch.from_numpy(case["mask"]),
                                 torch.from_numpy(case["gn"]), torch.Generator().manual_seed(3))
    R = got.pose[:3, :3].numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(R) > 0.99
    assert np.linalg.norm(got.pose[:3, 3].numpy() - case["center"]) < 0.05
    counts = got.inlier_counts.numpy()
    assert list(counts) == sorted(counts, reverse=True)
    if case["name"] == "tabletop":
        assert bool(got.valid)
    else:
        # The bench camera looks straight down on a 3 cm box: its sides are
        # edge-on, so only the top face is found (as in the JAX package).
        assert not bool(got.valid) and counts[0] > 300 and counts[1] == counts[2] == 0


def test_surface_frame_needs_triplets(case):
    with pytest.raises(ValueError, match="generator or indices"):
        estimate_surface_frame(torch.from_numpy(case["dpts"]), torch.from_numpy(case["mask"]),
                               torch.from_numpy(case["gn"]))
