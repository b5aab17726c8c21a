"""The port's depth-image normals against the JAX package.

Tolerances: normals within atol 1e-6 (norms and the cross product round
in another order); validity equal. On a random cloud a tangent length can
sit within an ulp of ``max_edge``, so there at most 0.1% of the validity
bits may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.ops import normals as jnormals
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.ops import normals
from test_odometry import render_room_depth, small_camera, trajectory

torch.set_num_threads(2)


def room_cloud(seed):
    jcam = small_camera()
    depth = render_room_depth(jcam, trajectory(seed + 1)[-1], seed=seed)
    depth[::7, ::5] = 0.0  # holes: invalid pixels
    cam = PinholeCamera.from_K(np.asarray(jcam.K), jcam.width, jcam.height)
    pts, valid = cam.backproject_depth(torch.from_numpy(depth), min_depth=0.1, max_depth=6.0)
    jpts, jvalid = jcam.backproject_depth(jnp.asarray(depth), min_depth=0.1, max_depth=6.0)
    h, w = depth.shape
    return (pts.reshape(h, w, 3), valid.reshape(h, w),
            jnp.asarray(jpts).reshape(h, w, 3), jnp.asarray(jvalid).reshape(h, w))


@pytest.mark.parametrize("seed,max_edge", [(0, 0.5), (3, 0.05)])
def test_normals_from_depth_match_on_the_room(seed, max_edge):
    pts, valid, jpts, jvalid = room_cloud(seed)
    n, v = normals.normals_from_depth(pts, valid, max_edge=max_edge)
    jn, jv = jnormals.normals_from_depth(jpts, jvalid, max_edge=max_edge)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6, rtol=0)
    assert 0.0 < v.float().mean() < 1.0  # both the edge gate and the holes bite


def test_normals_point_to_the_viewpoint_on_a_random_cloud():
    rng = np.random.RandomState(1)
    p = (rng.rand(24, 32, 3) * [1.0, 1.0, 0.2] + [0, 0, 1.0]).astype(np.float32)
    valid = rng.rand(24, 32) > 0.1
    vp = (0.3, -0.2, 5.0)
    n, v = normals.normals_from_depth(torch.from_numpy(p), torch.from_numpy(valid), viewpoint=vp, max_edge=0.4)
    jn, jv = jnormals.normals_from_depth(jnp.asarray(p), jnp.asarray(valid), viewpoint=vp, max_edge=0.4)
    assert (v.numpy() != np.asarray(jv)).mean() <= 1e-3
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6, rtol=0)
    to_vp = np.asarray(vp, np.float32) - p
    assert (np.sum(n.numpy() * to_vp, axis=-1) >= 0).all()


def test_normals_knn_in_eigh_chunks_equal_one_call(monkeypatch):
    """normals_knn splits its batched eigh into chunks (cuSOLVER refuses
    more than 16384 matrices in one call): chunks, here of 300, give the
    same normals as one call over the whole cloud."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy((rng.uniform(-0.5, 0.5, (1000, 3)) * [1.0, 1.0, 0.05]).astype(np.float32))
    mask = torch.ones(1000, dtype=torch.bool)
    whole = normals.normals_knn(pts, mask, k=8)
    monkeypatch.setattr(normals, "_EIGH_BATCH", 300)
    chunked = normals.normals_knn(pts, mask, k=8)
    assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])
