"""The port's colour detector, image ops and bbox filter against the JAX
package, on seeded numpy images and ``tests/test_image.py``'s scenes.

Tolerances: HSV, masks, morphology, the component bbox, ``red_mask`` and
``detect_red_object`` exact (integer and IEEE float32 arithmetic in the
same order); ``project_P`` within 1e-4 px or 2 float32 ulps (2.4e-7
relative; an ulp at 512-1024 px is 6.1e-5 px) for points that land
within a frame of the image (a 4-term matmul summed in another order); ``filter_by_rect`` exact for points more than 1e-3 px
from the rectangle's edges.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.models import bbox_filter as jbbox
from perception_tpu.models import color_detect as jcd
from perception_tpu.ops import image as jimg
from perception_tpu_torch.models import bbox_filter as bbox
from perception_tpu_torch.models import color_detect as cd
from perception_tpu_torch.ops import image as img

torch.set_num_threads(2)

P_COLOR = np.array([  # the reference's colour camera (README.md:39-55)
    [616.8246459960938, 0.0, 321.81976318359375, 0.0],
    [0.0, 616.609375, 239.91116333007812, 0.0],
    [0.0, 0.0, 1.0, 0.0],
], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bb(b):
    return [int(x) for x in b]


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_and_in_range_match(seed):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (48, 64, 3), np.uint8)
    rgb[0, :8] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                  [255, 0, 1], [200, 200, 0]]
    want = np.asarray(jimg.rgb_to_hsv_cv(jnp.asarray(rgb)))
    got = img.rgb_to_hsv_cv(_t(rgb)).numpy()
    np.testing.assert_array_equal(got, want)
    lo, hi = (0.0, 50.0, 100.0), (10.0, 255.0, 255.0)
    np.testing.assert_array_equal(img.in_range(_t(want), lo, hi).numpy(),
                                  np.asarray(jimg.in_range(jnp.asarray(want), lo, hi)))
    f = rgb.astype(np.float32) / 3.0
    np.testing.assert_array_equal(img.rgb_to_hsv_cv(_t(f)).numpy(), np.asarray(jimg.rgb_to_hsv_cv(jnp.asarray(f))))


@pytest.mark.parametrize("size,iterations", [(5, 1), (5, 2), (3, 3)])
def test_morphology_matches(size, iterations):
    m = np.random.RandomState(size + iterations).rand(64, 80) > 0.6
    m[:, :3] = True  # foreground at the border: erosion pads with 1
    for op in ("erode", "dilate"):
        want = np.asarray(getattr(jimg, op)(jnp.asarray(m), size, iterations))
        got = getattr(img, op)(_t(m), size, iterations).numpy()
        np.testing.assert_array_equal(got, want)


def test_morphology_against_opencv_interior():
    mask = (np.random.RandomState(1).rand(64, 64) > 0.7).astype(np.uint8) * 255
    kernel = np.ones((5, 5), np.uint8)
    np.testing.assert_array_equal(img.erode(_t(mask > 0), 5, 2).numpy(), cv2.erode(mask, kernel, iterations=2) > 0)
    np.testing.assert_array_equal(img.dilate(_t(mask > 0), 5, 2).numpy(), cv2.dilate(mask, kernel, iterations=2) > 0)


def _snake():
    mask = np.zeros((40, 40), bool)
    mask[5, 5:35] = True
    mask[5:35, 34] = True
    mask[20, 5:10] = True
    return mask


@pytest.mark.parametrize("case", ["random", "snake", "empty", "two", "spiral"])
def test_largest_component_bbox_matches(case):
    rng = np.random.RandomState(7)
    if case == "random":
        m = rng.rand(50, 70) > 0.45
    elif case == "snake":
        m = _snake()
    elif case == "empty":
        m = np.zeros((20, 20), bool)
    elif case == "two":  # two equal areas: the first maximum wins
        m = np.zeros((30, 30), bool)
        m[2:6, 2:6] = True
        m[20:24, 20:24] = True
    else:  # a spiral longer than max_iters rounds of propagation can settle
        m = np.zeros((41, 41), bool)
        lo, hi = 1, 39
        while hi - lo > 2:
            m[lo, lo:hi + 1] = m[lo:hi + 1, hi] = m[hi, lo:hi + 1] = True
            m[lo + 2:hi + 1, lo] = True
            m[lo + 2, lo:lo + 3] = True
            lo, hi = lo + 4, hi - 4
    for iters in (64, 8):
        want = jimg.largest_component_bbox(jnp.asarray(m), max_iters=iters)
        got = img.largest_component_bbox(_t(m), max_iters=iters)
        assert _bb(got) == _bb(want)
        assert all(t.dtype == (torch.bool if i == 5 else torch.int32) for i, t in enumerate(got))
    if case == "snake":
        assert _bb(got)[:5] == [5, 5, 34, 34, 59]


def test_detect_red_object_matches():
    im = np.full((120, 160, 3), (30, 80, 40), np.uint8)
    im[40:70, 50:100] = (200, 20, 20)
    got, want = cd.detect_red_object(_t(im)), jcd.detect_red_object(jnp.asarray(im))
    assert _bb(got) == _bb(want) == [40, 30, 109, 79, 1]
    np.testing.assert_array_equal(cd.red_mask(_t(im)).numpy(), np.asarray(jcd.red_mask(jnp.asarray(im))))


def test_detect_red_wraparound_hue_matches():
    hsv = np.zeros((40, 40, 3), np.uint8)
    hsv[..., 0], hsv[..., 1], hsv[..., 2] = 177, 200, 220
    im = np.full((60, 60, 3), 255, np.uint8)
    im[10:50, 10:50] = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    got, want = cd.detect_red_object(_t(im)), jcd.detect_red_object(jnp.asarray(im))
    assert _bb(got) == _bb(want)
    assert bool(got.valid) and int(got.x1) == 0


def test_red_constants_equal():
    for name in ("LOWER_RED1", "UPPER_RED1", "LOWER_RED2", "UPPER_RED2", "MARGIN"):
        assert getattr(cd, name) == getattr(jcd, name)


@pytest.mark.parametrize("seed", [0, 3])
def test_detect_red_noisy_scene_matches(seed):
    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, (96, 128, 3), np.uint8)
    im[..., 1] = np.maximum(im[..., 1], im[..., 0])  # background never red
    im[20:60, 30:90] = np.clip(np.array([200, 20, 20]) + rng.randint(-10, 11, (40, 60, 3)), 0, 255)
    im[70:80, 100:115] = (210, 30, 25)  # a smaller red blob
    got, want = cd.detect_red_object(_t(im)), jcd.detect_red_object(jnp.asarray(im))
    assert _bb(got) == _bb(want)
    np.testing.assert_array_equal(cd.red_mask(_t(im)).numpy(), np.asarray(jcd.red_mask(jnp.asarray(im))))


def test_project_and_filter_match():
    rng = np.random.RandomState(4)
    pts = np.concatenate([rng.uniform(-0.4, 0.4, (2000, 2)), rng.uniform(-0.5, 2.0, (2000, 1))], 1).astype(np.float32)
    mask = rng.rand(2000) > 0.1
    want = np.asarray(jbbox.project_P(jnp.asarray(P_COLOR), jnp.asarray(pts)))
    got = bbox.project_P(_t(P_COLOR), _t(pts)).numpy()
    seen = (pts[:, 2] > 0.05) & np.all((want > -320) & (want < 960), axis=1)
    assert seen.sum() > 1000
    np.testing.assert_allclose(got[seen], want[seen], rtol=2.4e-7, atol=1e-4)
    rect = (250, 180, 420, 330)
    fw = np.asarray(jbbox.filter_by_rect(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(P_COLOR), rect))
    fg = bbox.filter_by_rect(_t(pts), _t(mask), _t(P_COLOR), rect).numpy()
    edge = np.zeros(2000, bool)
    for k, c in enumerate(rect):
        edge |= np.abs(want[:, k % 2] - c) <= 1e-3
    np.testing.assert_array_equal(fg[~edge], fw[~edge])
    assert 100 < fg.sum() < 2000
    r = cd.Rectangle(*(torch.tensor(v, dtype=torch.int32) for v in rect), torch.tensor(True))
    np.testing.assert_array_equal(bbox.filter_by_rect(_t(pts), _t(mask), _t(P_COLOR), r[:4]).numpy(), fg)


def test_reference_filter_and_bbox_cases():
    pts = np.array([[0.0, 0.0, 1.0], [0.5, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    out = bbox.filter_by_rect(_t(pts), torch.ones(3, dtype=torch.bool), _t(P_COLOR), (300, 220, 340, 260))
    np.testing.assert_array_equal(out.numpy(), [True, False, False])
    P = np.array([[600.0, 0, 320, 0], [0, 600.0, 240, 0], [0, 0, 1, 0]], np.float32)
    rng = np.random.RandomState(5)
    verts = (rng.uniform(-0.2, 0.2, (8, 3)) + [0, 0, 1.5]).astype(np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [0.015, 0.0, 0.001]
    want = np.asarray(jbbox.project_bbox(jnp.asarray(P), jnp.asarray(E), jnp.asarray(verts)))
    np.testing.assert_allclose(bbox.project_bbox(_t(P), _t(E), _t(verts)).numpy(), want, rtol=0, atol=1e-4)
