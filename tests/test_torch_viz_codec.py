"""The port's display, codec, saver and device-reader leaves against the JAX
package on the CPU: ``io/colors``, ``io/imgcodec``, ``models/viz``,
``io/gui.Gui3D``, the COCO / keypoint / heatmap savers and the camera
readers of ``io/producers``.

Every comparison is exact: the colour table and names; every encoding
round-tripped (little- and big-endian, padded rows); every conversion, on
numpy arrays and on tensors; the TURBO table against ``cv2.applyColorMap``;
``depth_to_vis`` with NaNs; ``render_points_3d`` on a random float64 cloud
(no z-ties) and on the bench frame's cloud with its default colours (ties
there share a colour); ``render_body_model`` and ``Gui3D``'s orbit frames;
the COCO JSON byte for byte. Inputs are numpy draws from seeded generators.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perception_tpu.io import colors as jcolors
from perception_tpu.io import imgcodec as jcodec
from perception_tpu.io import savers as jsavers
from perception_tpu.models import viz as jviz
from perception_tpu_torch.io import colors, imgcodec, savers
from perception_tpu_torch.models import viz


def test_color_table_and_names_equal_jax():
    assert colors.N_COLORS == jcolors.N_COLORS == 146
    assert colors._NAMES == jcolors._NAMES
    assert np.array_equal(colors._TABLE, jcolors._TABLE)
    for i in (-1, 0, 7, 145, 146, 1000):
        assert colors.color_name(i) == jcolors.color_name(i)
        assert np.array_equal(colors.get_rgb_color(i), jcolors.get_rgb_color(i))


@pytest.mark.parametrize("background", [-1, 0, 5])
def test_label_image_to_rgb8_equals_jax(background):
    labels = np.random.default_rng(0).integers(-3, 500, (37, 53)).astype(np.int32)
    want = jcolors.label_image_to_rgb8(labels, background)
    assert np.array_equal(colors.label_image_to_rgb8(labels, background), want)
    got = colors.label_image_to_rgb8(torch.as_tensor(labels), background)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def _image(enc, rng, h=7, w=9):
    dtype, ch = imgcodec.ENCODINGS[enc]
    shape = (h, w, ch) if ch > 1 else (h, w)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("enc", sorted(jcodec.ENCODINGS))
def test_every_encoding_round_trips_like_jax(enc):
    assert imgcodec.ENCODINGS[enc] == jcodec.ENCODINGS[enc]
    arr = _image(enc, np.random.default_rng(len(enc)))
    msg = imgcodec.array_to_image(arr, enc)
    assert msg == jcodec.array_to_image(arr, enc)
    assert imgcodec.array_to_image(torch.as_tensor(arr) if arr.dtype != np.uint16 else arr, enc) == msg
    assert np.array_equal(imgcodec.image_to_array(msg), arr)
    itemsize = np.dtype(arr.dtype).itemsize
    # Big-endian payload, and rows padded to a longer step.
    big = dict(msg, is_bigendian=True, data=arr.astype(arr.dtype.newbyteorder(">")).tobytes())
    rows = np.frombuffer(msg["data"], np.uint8).reshape(msg["height"], msg["step"])
    pad = 3 * itemsize + 1
    padded = dict(msg, step=msg["step"] + pad,
                  data=np.concatenate([rows, np.full((msg["height"], pad), 0xAB, np.uint8)], 1).tobytes())
    for m in (msg, big, padded):
        got, want = imgcodec.image_to_array(m), jcodec.image_to_array(m)
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
        assert np.array_equal(got, arr)


def test_encoding_errors_equal_jax():
    with pytest.raises(ValueError, match="unsupported encoding"):
        imgcodec.image_to_array({"encoding": "yuv422", "height": 1, "width": 1, "step": 2, "data": b"\0\0"})
    with pytest.raises(ValueError, match="does not match"):
        imgcodec.array_to_image(np.zeros((4, 4), np.uint8), "rgb8")


def _conversions():
    pairs = list(jcodec._COLOR_PERMUTES)
    pairs += [("rgb8", "mono8"), ("bgr8", "mono8"), ("mono8", "rgb8"), ("mono8", "bgr8"), ("mono16", "mono8"),
              ("mono8", "mono16"), ("rgba8", "rgb8"), ("bgra8", "bgr8"), ("rgb8", "rgba8"), ("bgr8", "bgra8"),
              ("rgb8", "rgb8")]
    return pairs


@pytest.mark.parametrize("src,dst", _conversions())
def test_convert_color_equals_jax(src, dst):
    arr = _image(src, np.random.default_rng(3), h=64, w=80)
    want = jcodec.convert_color(arr, src, dst)
    assert np.array_equal(imgcodec.convert_color(arr, src, dst), want)
    got = imgcodec.convert_color(torch.as_tensor(arr), src, dst)
    assert np.asarray(got.numpy()).dtype == want.dtype and np.array_equal(got.numpy(), want)


def test_convert_color_error_equals_jax():
    with pytest.raises(ValueError, match="no conversion"):
        imgcodec.convert_color(np.zeros((2, 2), np.uint16), "mono16", "rgb8")


def _display_cases():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.3, 3.0, (48, 64)).astype(np.float32)
    depth[0, :3] = np.nan
    depth[1, 1] = np.inf
    return [
        ("32FC1 dynamic", depth, "32FC1", "bgr8", dict(do_dynamic_scaling=True)),
        ("32FC1 window", depth, "32FC1", "rgb8", dict(min_image_value=0.5, max_image_value=2.0)),
        ("32FC1 default", depth, "32FC1", "bgr8", {}),
        ("64FC1 dynamic", depth.astype(np.float64), "64FC1", "mono8", dict(do_dynamic_scaling=True)),
        ("16UC1 default", rng.integers(0, 65536, (48, 64)).astype(np.uint16), "16UC1", "bgr8", {}),
        ("16SC1 dynamic", rng.integers(-300, 300, (48, 64)).astype(np.int16), "16SC1", "bgr8",
         dict(do_dynamic_scaling=True)),
        ("32FC1 all NaN", np.full((8, 8), np.nan, np.float32), "32FC1", "bgr8", dict(do_dynamic_scaling=True)),
        ("32SC1 labels", (np.arange(48 * 64, dtype=np.int32).reshape(48, 64) % 7 - 1), "32SC1", "rgb8", {}),
        ("32SC1 labels bgr", rng.integers(-1, 400, (48, 64)).astype(np.int32), "32SC1", "bgr8", {}),
        ("rgb8 passthrough", rng.integers(0, 256, (48, 64, 3)).astype(np.uint8), "rgb8", "bgr8", {}),
    ]


@pytest.mark.parametrize("name,arr,src,dst,kw", _display_cases(), ids=lambda x: x if isinstance(x, str) else "")
def test_cvt_color_for_display_equals_jax(name, arr, src, dst, kw):
    want = jcodec.cvt_color_for_display(arr, src, dst, **kw)
    assert np.array_equal(imgcodec.cvt_color_for_display(arr, src, dst, **kw), want)
    got = imgcodec.cvt_color_for_display(torch.as_tensor(arr), src, dst, **kw)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_png_compressed_round_trip_decodes_like_cv2():
    rng = np.random.default_rng(5)
    for arr in (rng.integers(0, 256, (30, 40, 3)).astype(np.uint8), rng.integers(0, 256, (30, 40)).astype(np.uint8),
                rng.integers(0, 65536, (30, 40)).astype(np.uint16)):
        msg = imgcodec.array_to_compressed(arr, "png")
        assert msg["format"] == "png"
        assert np.array_equal(imgcodec.compressed_to_array(msg), arr)
        assert np.array_equal(jcodec.compressed_to_array(msg), arr)  # cv2 reads the port's PNG
        assert np.array_equal(imgcodec.compressed_to_array(jcodec.array_to_compressed(arr, "png")), arr)
    # An RGBA PNG loses its alpha, as through cv2.
    rgba = rng.integers(0, 256, (10, 12, 4)).astype(np.uint8)
    msg = imgcodec.array_to_compressed(rgba, "png")
    assert np.array_equal(imgcodec.compressed_to_array(msg), rgba[..., :3])


def test_jpeg_goes_through_cv2_like_jax():
    arr = np.random.default_rng(6).integers(0, 256, (32, 48, 3)).astype(np.uint8)
    msg = imgcodec.array_to_compressed(arr, "jpg", quality=90)
    assert msg == jcodec.array_to_compressed(arr, "jpg", quality=90)
    assert np.array_equal(imgcodec.compressed_to_array(msg), jcodec.compressed_to_array(msg))
    with pytest.raises(ValueError, match="unsupported compressed format"):
        imgcodec.array_to_compressed(arr, "bmp")


def test_jpeg_without_cv2_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    arr = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cv2"):
        imgcodec.array_to_compressed(arr, "jpg")
    with pytest.raises(RuntimeError, match="cv2"):
        imgcodec.compressed_to_array({"format": "jpg", "data": b"\xff\xd8\xff"})
    # PNG needs no cv2.
    assert np.array_equal(imgcodec.compressed_to_array(imgcodec.array_to_compressed(arr, "png")), arr)


def test_turbo_table_equals_cv2():
    import cv2

    grey = np.arange(256, dtype=np.uint8).reshape(1, 256)
    assert np.array_equal(viz.TURBO_RGB, cv2.applyColorMap(grey, cv2.COLORMAP_TURBO)[0, :, ::-1])


@pytest.mark.parametrize("max_depth", [5.0, 1.2])
def test_depth_to_vis_with_nans_equals_jax(max_depth):
    rng = np.random.default_rng(7)
    depth = rng.uniform(-0.5, 7.0, (60, 80)).astype(np.float32)
    depth[::5, ::3] = np.nan
    depth[2, 2], depth[3, 3] = np.inf, -np.inf
    want = jviz.depth_to_vis(depth, max_depth)
    assert np.array_equal(viz.depth_to_vis(depth, max_depth), want)
    got = viz.depth_to_vis(torch.as_tensor(depth), max_depth)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def _bench_cloud():
    from perception_tpu_torch.bench.scene import render_depth_tabletop
    from perception_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.d435_depth()
    pts, mask = cam.backproject_depth(torch.as_tensor(render_depth_tabletop(cam, seed=0)))
    return pts[mask].numpy()


def _render_cases():
    rng = np.random.default_rng(8)
    cloud = rng.normal(size=(20000, 3)) * [0.3, 0.3, 0.2] + [0.0, 0.0, 0.8]  # float64: no z-ties
    cols = rng.integers(0, 256, (20000, 3)).astype(np.uint8)
    mask = rng.random(20000) < 0.7
    return [
        ("random default colours", cloud, dict(size=(120, 160))),
        ("random given colours and mask", cloud, dict(colors=cols, mask=mask, size=(96, 128), point_px=3)),
        ("random one-pixel points", cloud, dict(size=(120, 160), point_px=1, eye=(0.5, -0.2, 0.0))),
        ("bench frame default colours", "bench", dict(size=(480, 640), eye=(0.45, -0.4, 0.02))),
    ]


@pytest.mark.parametrize("name,cloud,kw", _render_cases(), ids=lambda x: x if isinstance(x, str) else "")
def test_render_points_3d_equals_jax(name, cloud, kw):
    if isinstance(cloud, str):
        cloud = _bench_cloud()
    want = jviz.render_points_3d(cloud, **kw)
    assert np.array_equal(viz.render_points_3d_reference(cloud, **kw), want)
    t_kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = viz.render_points_3d(torch.as_tensor(cloud), **t_kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(viz.render_points_3d(cloud, **kw), want)  # numpy in, numpy out


def test_render_points_3d_tie_goes_to_the_lowest_index():
    pts = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 2.0]])
    cols = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90]], np.uint8)
    img = viz.render_points_3d(torch.as_tensor(pts), colors=torch.as_tensor(cols), size=(20, 20),
                               eye=(0.0, 0.0, 0.0), target=(0.0, 0.0, 1.0))
    assert img[10, 10].tolist() == [10, 20, 30]


def test_render_body_model_equals_jax():
    rng = np.random.default_rng(9)
    parents = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8])
    joints = rng.normal(size=(10, 3)) * 0.3 + [0.0, 0.0, 2.0]
    want = jviz.render_body_model(joints, parents, size=(120, 160))
    assert np.array_equal(viz.render_body_model(joints, parents, size=(120, 160)), want)
    got = viz.render_body_model(torch.as_tensor(joints), torch.as_tensor(parents), size=(120, 160))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


def test_gui3d_orbit_frames_equal_jax():
    from perception_tpu.io.gui import FrameDisplayer as JDisplayer
    from perception_tpu.io.gui import Gui3D as JGui3D
    from perception_tpu_torch.io.gui import FrameDisplayer, Gui3D

    cloud = _bench_cloud()[::50]
    mine, theirs = [], []
    g = Gui3D(hw=(120, 160), orbit_step_deg=30.0, displayer=FrameDisplayer(sink=mine.append))
    j = JGui3D(hw=(120, 160), orbit_step_deg=30.0, displayer=JDisplayer(sink=theirs.append))
    for _ in range(4):
        out = g.update(torch.as_tensor(cloud))
        j.update(cloud)
        assert isinstance(out, torch.Tensor)
    assert len(mine) == 4 and all(np.array_equal(a, b) for a, b in zip(mine, theirs))
    assert not np.array_equal(mine[0], mine[1])


def test_overlays_draw_like_jax():
    from perception_tpu.io.templates import CUBOID_EDGES

    img = np.zeros((100, 120, 3), np.uint8)
    kps = np.zeros((2, 3, 3), np.float32)
    kps[0] = [(20, 20, 1), (40, 40, 1), (20, 60, 1)]
    kps[1] = [(80, 20, 1), (90, 40, 1), (80, 60, 0)]
    pairs = np.array([(0, 1), (1, 2)])
    mask = np.array([True, True])
    assert np.array_equal(viz.draw_skeletons(img, torch.as_tensor(kps), torch.as_tensor(mask), pairs),
                          jviz.draw_skeletons(img, kps, mask, pairs))
    assert np.array_equal(viz.draw_bbox_2d(img, (10, 10, 50, 60)), jviz.draw_bbox_2d(img, (10, 10, 50, 60)))
    verts = np.array([[20 + 10 * (i & 1), 30 + 10 * ((i >> 1) & 1)] for i in range(8)], np.float32)
    assert np.array_equal(viz.draw_cuboid_bbox(img, verts, CUBOID_EDGES), jviz.draw_cuboid_bbox(img, verts, CUBOID_EDGES))
    lms = np.array([[10.0, 10.0], [30.0, 30.0]])
    lm_mask = np.array([True, False])
    assert np.array_equal(viz.landmarks_overlay(img, lms, lm_mask), jviz.landmarks_overlay(img, lms, lm_mask))
    assert img.sum() == 0


COCO_BRANCHES = [
    *(("body", n, 0) for n in (23, 18, 19, 25, 59, 135, 17, 15)),
    *(("foot", n, 0) for n in (25, 23, 135, 18)),
    ("face", 135, 0), ("face", 25, 0), ("hand21", 135, 0), ("hand21", 25, 0), ("hand42", 135, 0),
    ("car", 12, 0), ("car", 22, 0), ("car", 22, 1), ("car", 22, 2), ("car", 22, 3), ("bogus", 25, 0),
]


@pytest.mark.parametrize("fmt,n,variant", COCO_BRANCHES)
def test_coco_order_indexes_equal_jax(fmt, n, variant):
    try:
        want = jsavers.coco_order_indexes(n, fmt, variant)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            savers.coco_order_indexes(n, fmt, variant)
        return
    assert savers.coco_order_indexes(n, fmt, variant) == want


@pytest.mark.parametrize("fmt,parts", [("body", 25), ("body", 15), ("foot", 25), ("face", 135), ("hand42", 135),
                                       ("car", 12)])
def test_coco_json_equals_jax(tmp_path, fmt, parts):
    rng = np.random.default_rng(parts)
    kps = [rng.uniform(0, 300, (4, parts, 3)).astype(np.float32) for _ in range(3)]
    for k in kps:
        k[..., 2] = np.where(rng.random(k.shape[:2]) < 0.3, 0.0, k[..., 2])
    masks = [rng.random(4) < 0.7 for _ in range(3)]
    scores = [rng.random(4).astype(np.float32) for _ in range(3)]
    want = jsavers.coco_keypoint_results([5, 6, 9], kps, masks, scores, fmt=fmt)
    got = savers.coco_keypoint_results([5, 6, 9], [torch.as_tensor(k) for k in kps],
                                       [torch.as_tensor(m) for m in masks], [torch.as_tensor(s) for s in scores],
                                       fmt=fmt)
    assert json.dumps(got) == json.dumps(want)
    savers.save_coco_json(tmp_path / "port.json", got)
    jsavers.save_coco_json(tmp_path / "jax.json", want)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = savers.load_coco_json(tmp_path / "port.json")
    assert back == jsavers.load_coco_json(tmp_path / "jax.json")
    mine, theirs = savers.coco_results_to_keypoints(back), jsavers.coco_results_to_keypoints(back)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(mine[k], theirs[k]))


def test_keypoint_and_heatmap_files_cross_packages(tmp_path):
    rng = np.random.default_rng(10)
    kp = rng.random((3, 25, 3)).astype(np.float32)
    savers.save_keypoints_npy(tmp_path / "kp.npy", torch.as_tensor(kp))
    assert np.array_equal(np.load(tmp_path / "kp.npy"), kp)
    hm = rng.random((2, 19, 16, 16)).astype(np.float32)
    savers.save_heatmaps(tmp_path / "port.npz", torch.as_tensor(hm))
    jsavers.save_heatmaps(tmp_path / "jax.npz", hm)
    for name in ("port.npz", "jax.npz"):
        for load in (savers.load_heatmaps, jsavers.load_heatmaps):
            got = load(tmp_path / name)
            assert got.dtype == np.float32 and np.array_equal(got, hm)


def test_producers_import_without_cv2_or_pyspin():
    code = ("import sys; sys.modules['cv2'] = None; sys.modules['PySpin'] = None\n"
            "import perception_tpu_torch.io.producers as p\n"
            "print(all(hasattr(p, n) for n in ('WebcamReader', 'IpCameraReader', 'FlirReader', 'VideoReader')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr


def test_readers_raise_the_jax_errors(monkeypatch):
    from perception_tpu.io import producers as jprod
    from perception_tpu_torch.io import producers

    for mod in (producers, jprod):
        with pytest.raises(RuntimeError, match="requires the Spinnaker SDK"):
            mod.FlirReader()
        with pytest.raises(ConnectionError, match="cannot open stream"):
            mod.IpCameraReader("/nonexistent/stream.mp4")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mod in (producers, jprod):
        with pytest.raises(ImportError):
            mod.WebcamReader(0)
        with pytest.raises(ImportError):
            mod.IpCameraReader("/nonexistent/stream.mp4")
