"""The port's full camera model against the JAX package's, on the CPU.

Every ``PinholeCamera`` method of ``perception_tpu/geometry/camera.py``
on the same numpy inputs: the constructors (``from_K`` with plumb_bob and
rational distortion, ``from_camera_info`` with binning and ROI, the D435
models) give the same float32 intrinsics; ``project``, ``pixel_to_ray``
(plain and normalised) and ``unrectify_point`` are bit-equal (both round
each operation in the same order, JAX eagerly); ``rectify_point`` within
1e-4 px (JAX runs its 5 steps as a compiled ``fori_loop``, which may
contract into FMAs); ``rectify_image`` within 1e-3 of 255 on uint8 and
float images, gray and colour (a source coordinate one ulp apart moves
the bilinear weights); ``rectify_roi`` and ``unrectify_roi`` equal;
``depth_from_u16`` bit-equal with NaN at the same places.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from perception_tpu.geometry import camera as jcam
from perception_tpu.geometry import se3 as jse3
from perception_tpu_torch.geometry import camera as tcam
from perception_tpu_torch.geometry import se3 as tse3

K_COLOR = (616.8246459960938, 0.0, 321.81976318359375,
           0.0, 616.609375, 239.91116333007812, 0.0, 0.0, 1.0)
DISTS = {
    "none": None,
    "plumb_bob": (0.12, -0.05, 0.001, -0.002, 0.01),
    "rational": (0.1, -0.04, 0.0015, -0.001, 0.008, 0.02, -0.01, 0.003),
}


def both(dist, K=K_COLOR, w=640, h=480):
    return (jcam.PinholeCamera.from_K(K, width=w, height=h, dist=dist),
            tcam.PinholeCamera.from_K(K, width=w, height=h, dist=dist))


def same_intrinsics(jc, tc):
    for name in ("fx", "fy", "cx", "cy"):
        assert np.float32(getattr(jc, name)) == np.float32(getattr(tc, name)), name
    np.testing.assert_array_equal(np.asarray(jc.dist), np.asarray(tc.dist, np.float32))
    assert (jc.width, jc.height) == (tc.width, tc.height)


def test_constructors_match():
    for dist in DISTS.values():
        same_intrinsics(*both(dist))
    same_intrinsics(jcam.PinholeCamera.d435_color(), tcam.PinholeCamera.d435_color())
    same_intrinsics(jcam.PinholeCamera.d435_depth(), tcam.PinholeCamera.d435_depth())
    with pytest.raises(ValueError, match="plumb_bob"):
        tcam.PinholeCamera.from_K(K_COLOR, dist=(0.1, 0.2, 0.3))


@pytest.mark.parametrize("binning,roi", [
    ((1, 1), (0, 0, 0, 0)), ((2, 2), (0, 0, 0, 0)), ((1, 1), (96, 64, 320, 240)),
    ((2, 3), (64, 32, 512, 384)),
])
def test_from_camera_info_matches(binning, roi):
    kw = dict(K=K_COLOR, width=640, height=480, D=DISTS["plumb_bob"],
              binning_x=binning[0], binning_y=binning[1], roi=roi)
    same_intrinsics(jcam.PinholeCamera.from_camera_info(jcam.CameraInfo(**kw)),
                    tcam.PinholeCamera.from_camera_info(tcam.CameraInfo(**kw)))


def test_from_camera_info_rejects_roi_outside():
    info = tcam.CameraInfo(K=K_COLOR, width=640, height=480, roi=(400, 0, 320, 240))
    with pytest.raises(ValueError, match="ROI"):
        tcam.PinholeCamera.from_camera_info(info)


def points_and_pixels(seed=0, n=500):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(0.3, 4, n)], -1)
    uv = np.stack([rng.uniform(-20, 660, n), rng.uniform(-20, 500, n)], -1)
    return pts.astype(np.float32), uv.astype(np.float32)


@pytest.mark.parametrize("name", list(DISTS))
def test_projection_and_distortion_match(name):
    jc, tc = both(DISTS[name])
    pts, uv = points_and_pixels()
    np.testing.assert_array_equal(tc.project(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jc.project(jnp.asarray(pts))))
    for normalize in (False, True):
        np.testing.assert_array_equal(tc.pixel_to_ray(torch.from_numpy(uv), normalize).numpy(),
                                      np.asarray(jc.pixel_to_ray(jnp.asarray(uv), normalize)))
    np.testing.assert_array_equal(tc.unrectify_point(torch.from_numpy(uv)).numpy(),
                                  np.asarray(jc.unrectify_point(jnp.asarray(uv))))
    np.testing.assert_allclose(tc.rectify_point(torch.from_numpy(uv)).numpy(),
                               np.asarray(jc.rectify_point(jnp.asarray(uv))), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["gray u8", "color u8", "gray f32"])
def test_rectify_image_matches(kind):
    rng = np.random.default_rng(3)
    h, w = 60, 80
    K = (70.0, 0, 41.3, 0, 69.0, 29.7, 0, 0, 1)
    jc, tc = both(DISTS["plumb_bob"], K=K, w=w, h=h)
    shape = (h, w, 3) if kind.startswith("color") else (h, w)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if kind.endswith("f32"):
        img = img.astype(np.float32) / 7.0
    got = tc.rectify_image(torch.from_numpy(img)).numpy()
    want = np.asarray(jc.rectify_image(jnp.asarray(img)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["plumb_bob", "rational"])
@pytest.mark.parametrize("roi", [(100, 80, 200, 150), (0, 0, 640, 480), (150, 120, 160, 120)])
def test_rois_match(name, roi):
    jc, tc = both(DISTS[name])
    assert tc.rectify_roi(roi) == jc.rectify_roi(roi)
    assert tc.unrectify_roi(roi) == jc.unrectify_roi(roi)


def test_depth_from_u16_matches():
    raw = np.random.default_rng(5).integers(0, 65536, (48, 64)).astype(np.uint16)
    raw[::7, ::5] = 0
    for scale in (1.0 / 5000.0, 0.001):
        got = tcam.depth_from_u16(raw, scale)
        want = jcam.depth_from_u16(raw, scale)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)  # NaN at the same places


def test_quat_to_matrix_matches():
    q = np.random.default_rng(7).normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_array_equal(tse3.quat_to_matrix(torch.from_numpy(q)).numpy(),
                                  np.asarray(jse3.quat_to_matrix(jnp.asarray(q))))
