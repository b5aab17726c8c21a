"""The port's geometry examples (``examples_torch/`` 01, 05, 08, 10) on
the CPU, each run as a script through ``runpy`` with
``PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu`` and held to its own asserts
(the JAX examples' thresholds); an example without the switch and without
a card stops, naming it. Example 08's numbers and example 10's ``Gui3D``
orbit frames are held to the JAX functions' on the same inputs (display
images and frames exact, the stereo point within 1e-6 m), and
``tools_torch/make_tum_fixture.py`` to the JAX tool's output (exact) and
to the committed ``tests/fixtures/tum_mini`` (frame lists and calibration
exact, ground truth within 5e-6, depth within one count, at its 30
frames; the committed fixture predates the current scene code: the JAX
tool's output differs from it as much, and from its colour frames by up
to 169 grey levels, which are not compared).
"""

import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["01_cuboid_pose_from_depth", "05_slam_on_a_sequence", "08_camera_models_and_display",
            "10_gui_and_3d_viewer"]


def run_example(stem, timeout=900):
    """Run ``examples_torch/<stem>.py`` as a script through ``runpy`` in a
    child process on the CPU, and fail with its output if it fails. The
    child's glibc keeps freed blocks in its heap (``MALLOC_MMAP_MAX_=0``):
    by default every block over 32 MB is mapped anew and returned at its
    free, and the CPU paths of ICP and clustering allocate such blocks each
    iteration, so page faults took most of the time (example 12: 125 s
    alone, 40 s so; 4 GB at its peak). Four torch threads: the suite's
    workers share the host's cores."""
    env = dict(os.environ, PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE="cpu", MALLOC_MMAP_MAX_="0",
               MALLOC_TRIM_THRESHOLD_=str(4 << 30), OMP_NUM_THREADS="4")
    code = f"import runpy; runpy.run_path({str(ROOT / 'examples_torch' / (stem + '.py'))!r}, run_name='__main__')"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE", "cpu")


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_runs_on_the_cpu(stem):
    run_example(stem)


def test_example_without_a_card_names_the_switch(monkeypatch):
    monkeypatch.delenv("PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu"):
        runpy.run_path(str(ROOT / "examples_torch" / "01_cuboid_pose_from_depth.py"), run_name="__main__")


def test_example_08_equals_jax(on_cpu):
    import jax.numpy as jnp

    from examples_torch._common import load
    from perception_tpu.geometry.camera import PinholeCamera
    from perception_tpu.geometry.stereo import StereoCamera
    from perception_tpu.io.imgcodec import cvt_color_for_display

    got = load("08_camera_models_and_display").main()
    cam = PinholeCamera.d435_depth()
    uv = jnp.asarray([[100.0, 80.0], [320.0, 240.0], [613.0, 470.0]])
    ray_err = float(jnp.max(jnp.abs(cam.project(cam.pixel_to_ray(uv) * 2.5) - uv)))
    xyz = np.asarray(StereoCamera(left=cam, baseline=jnp.float32(0.05)).project_disparity_to_3d(
        jnp.asarray([300.0, 220.0]), jnp.float32(9.5)))
    depth = np.random.RandomState(1).uniform(0.3, 3.0, (48, 64)).astype(np.float32)
    labels = np.arange(48 * 64, dtype=np.int32).reshape(48, 64) % 7 - 1
    assert abs(got["ray_err"] - ray_err) <= 1e-6
    assert np.abs(got["xyz"] - xyz).max() <= 1e-6
    assert np.array_equal(got["depth_display"], cvt_color_for_display(depth, "32FC1", "bgr8", do_dynamic_scaling=True))
    assert np.array_equal(got["label_display"], cvt_color_for_display(labels, "32SC1", "rgb8"))


def test_example_10_viewer_equals_jax(on_cpu):
    import jax.numpy as jnp

    from examples_torch._common import load
    from perception_tpu.geometry.camera import PinholeCamera
    from perception_tpu.io.gui import FrameDisplayer, Gui3D
    from perception_tpu_torch.bench.scene import render_depth_tabletop

    got = load("10_gui_and_3d_viewer").main()
    assert got["bytes"] > 1000
    cam = PinholeCamera.d435_depth()
    pts, mask = cam.backproject_depth(jnp.asarray(render_depth_tabletop(cam, seed=0)))
    jax_cloud = np.asarray(pts)[np.asarray(mask)][::50]
    assert got["cloud"].shape == jax_cloud.shape and np.abs(got["cloud"] - jax_cloud).max() <= 1e-6
    frames = []
    g3 = Gui3D(hw=(120, 160), orbit_step_deg=30.0, displayer=FrameDisplayer(sink=frames.append))
    for _ in range(4):
        g3.update(got["cloud"])
    assert all(np.array_equal(a, b) for a, b in zip(got["orbit_frames"], frames))


def _png_max_diff(a_dir, b_dir, kind, n):
    from perception_tpu_torch.io.png import read_png

    a, b = (sorted((d / kind).glob("*.png"))[:n] for d in (a_dir, b_dir))
    assert len(a) == len(b) == n
    return max(int(np.abs(read_png(x).astype(np.int64) - read_png(y).astype(np.int64)).max()) for x, y in zip(a, b))


def test_make_tum_fixture_equals_the_jax_tool_and_the_committed_fixture(tmp_path):
    # The committed fixture's 30 frames: sweep_trajectory(n) depends on n, and
    # at n = 3 the two packages' se3_exp part by 6e-8, a depth count here and there.
    frames = 30
    port, jax_out, committed = tmp_path / "port", tmp_path / "jax", ROOT / "tests" / "fixtures" / "tum_mini"
    tool = runpy.run_path(str(ROOT / "tools_torch" / "make_tum_fixture.py"))
    assert tool["main"](["--frames", str(frames), "--out", str(port)]) == 0
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_tum_fixture.py"), "--frames", str(frames),
                    "--out", str(jax_out)], check=True, timeout=300, capture_output=True)
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt", "calibration.txt"):
        assert (port / name).read_text() == (jax_out / name).read_text(), name
    assert _png_max_diff(port, jax_out, "rgb", frames) == 0 and _png_max_diff(port, jax_out, "depth", frames) == 0

    assert (port / "calibration.txt").read_text() == (committed / "calibration.txt").read_text()
    for name in ("rgb.txt", "depth.txt"):
        assert (port / name).read_text() == (committed / name).read_text()
    gt = [np.loadtxt(d / "groundtruth.txt") for d in (port, committed)]
    assert np.abs(gt[0] - gt[1]).max() <= 5e-6
    assert _png_max_diff(port, committed, "depth", frames) <= 1


def test_example_10_writes_png_frames_without_cv2(on_cpu, monkeypatch):
    from examples_torch._common import load

    monkeypatch.setitem(sys.modules, "cv2", None)
    got = load("10_gui_and_3d_viewer").main()
    assert got["sink"].startswith("png frames") and got["bytes"] > 1000
