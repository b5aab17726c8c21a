"""The port's TUM sequence reader and trajectory files against the JAX
package's, on the CPU.

On ``tests/fixtures/tum_mini`` the port's ``TumSequence`` (through its
own PNG codec, frame by frame and as ``frames(start, stop, step)``)
gives the JAX one's length, associations and timestamps, depth
bit-equal with NaN at the same places, rgb equal, and ``gt_pose`` within
1e-7. For the same
poses ``write_trajectory`` writes the JAX package's text, and
``read_trajectory`` reads a file to the JAX package's poses within 1e-7.
``associate``, ``read_file_list``, ``sequence_camera`` (with and without
``calibration.txt``) and ``tum_camera`` agree exactly. The port's
sequence writer (``bench/tum_sequence.py``) and ``tools/make_tum_fixture.py``
write the same sweep: equal index and calibration files, ground truth
within one unit of the sixth decimal, rgb equal and depth counts within 1
(the two trajectories come from two ``se3_exp``s, equal to ~1e-7).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from perception_tpu.geometry import se3 as jse3
from perception_tpu.io import tum as jtum
from perception_tpu_torch.bench.tum_sequence import make_sequence
from perception_tpu_torch.io import tum as ttum

REPO = Path(__file__).resolve().parents[1]
TUM_MINI = REPO / "tests" / "fixtures" / "tum_mini"


def same_camera(a, b):
    for f in ("fx", "fy", "cx", "cy"):
        assert np.float32(getattr(a, f)) == np.float32(getattr(b, f)), f
    assert (a.width, a.height) == (b.width, b.height)


def same_frame(t, j):
    assert t.timestamp == j.timestamp
    assert t.depth.dtype == j.depth.dtype == np.float32
    np.testing.assert_array_equal(t.depth, j.depth)  # NaN at the same places
    if j.rgb is None:
        assert t.rgb is None
    else:
        assert t.rgb.dtype == j.rgb.dtype and t.rgb.shape == j.rgb.shape
        np.testing.assert_array_equal(t.rgb, j.rgb)
    np.testing.assert_allclose(t.gt_pose, j.gt_pose, atol=1e-7, rtol=0)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_sequence_matches_jax_on_tum_mini(with_rgb):
    t, j = ttum.TumSequence(TUM_MINI, with_rgb=with_rgb), jtum.TumSequence(TUM_MINI, with_rgb=with_rgb)
    assert len(t) == len(j) == 30
    assert t.rgb_of_depth == j.rgb_of_depth and t.gt_of_depth == j.gt_of_depth
    for i in range(len(j)):
        same_frame(t.frame(i), j.frame(i))


def test_invalid_depth_is_nan_at_the_same_places(tmp_path):
    """tum_mini has no invalid pixel: a cv2-written sequence with zeros."""
    import cv2

    (tmp_path / "depth").mkdir()
    (tmp_path / "rgb").mkdir()
    rng = np.random.default_rng(4)
    lines = {"depth": [], "rgb": [], "gt": []}
    for i in range(3):
        t = 100.0 + i * 0.033
        d = rng.integers(4000, 20000, (24, 31)).astype(np.uint16)
        d[rng.random(d.shape) < 0.2] = 0
        cv2.imwrite(str(tmp_path / f"depth/{t:.6f}.png"), d, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
        cv2.imwrite(str(tmp_path / f"rgb/{t:.6f}.png"), rng.integers(0, 256, (24, 31, 3)).astype(np.uint8))
        lines["depth"].append(f"{t:.6f} depth/{t:.6f}.png")
        lines["rgb"].append(f"{t + 0.004:.6f} rgb/{t:.6f}.png")
        lines["gt"].append(f"{t + 0.001:.6f} {0.1 * i:.4f} 0.2 -0.1 0.1 -0.2 0.05 0.97")
    for name, rows in (("depth.txt", lines["depth"]), ("rgb.txt", lines["rgb"]), ("groundtruth.txt", lines["gt"])):
        (tmp_path / name).write_text("# test\n" + "\n".join(rows))
    t, j = ttum.TumSequence(tmp_path), jtum.TumSequence(tmp_path)
    for i in range(3):
        same_frame(t.frame(i), j.frame(i))
        assert np.isnan(t.frame(i).depth).sum() > 50


@pytest.mark.parametrize("span", [(0, None, 1), (2, 29, 3)])
def test_frames_stream_matches_jax(span):
    t, j = ttum.TumSequence(TUM_MINI), jtum.TumSequence(TUM_MINI)
    got, want = list(t.frames(*span)), list(j.frames(*span))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        same_frame(a, b)


def test_cameras_match(tmp_path):
    same_camera(ttum.sequence_camera(TUM_MINI), jtum.sequence_camera(TUM_MINI))
    for fb in (1, 2, 3, 7):
        same_camera(ttum.tum_camera(fb), jtum.tum_camera(fb))
        same_camera(ttum.sequence_camera(tmp_path, fb), jtum.sequence_camera(tmp_path, fb))
    assert ttum.TUM_DEPTH_SCALE == jtum.TUM_DEPTH_SCALE


def test_associate_and_file_lists_match():
    rng = np.random.default_rng(0)
    a = [(float(t), ["a"]) for t in np.sort(rng.uniform(0, 3, 60))]
    b = [(float(t), ["b"]) for t in np.sort(rng.uniform(0, 3, 45))]
    for max_dt, offset in ((0.02, 0.0), (0.05, 0.01), (0.2, -0.03)):
        assert ttum.associate(a, b, max_dt, offset) == jtum.associate(a, b, max_dt, offset)
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt"):
        assert ttum.read_file_list(TUM_MINI / name) == jtum.read_file_list(TUM_MINI / name)


def test_trajectory_files_match(tmp_path):
    xi = np.random.RandomState(0).randn(6, 6).astype(np.float32) * 0.3
    poses = [np.eye(4)] + list(np.asarray(jse3.se3_exp(jnp.asarray(xi))))
    ts = [1000.0 + i / 30.0 for i in range(len(poses))]
    ttum.write_trajectory(tmp_path / "t.txt", ts, poses)
    jtum.write_trajectory(tmp_path / "j.txt", ts, poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for path in (tmp_path / "j.txt", TUM_MINI / "groundtruth.txt"):
        (t_ts, t_poses), (j_ts, j_poses) = ttum.read_trajectory(path), jtum.read_trajectory(path)
        np.testing.assert_array_equal(t_ts, j_ts)
        assert t_poses.dtype == j_poses.dtype
        np.testing.assert_allclose(t_poses, j_poses, atol=1e-7, rtol=0)
    np.testing.assert_allclose(ttum.read_trajectory(tmp_path / "t.txt")[1], np.stack(poses), atol=1e-5)


def test_sequence_writer_matches_the_fixture_tool(tmp_path):
    """Both writers at 5 frames of 32x24."""
    make_sequence(tmp_path / "port", frames=5, width=32, height=24, threads=2)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_tum_fixture.py"), "--frames", "5", "--width", "32",
         "--height", "24", "--out", str(tmp_path / "jax")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    port, ref = tmp_path / "port", tmp_path / "jax"

    def body(path):
        return [line for line in path.read_text().splitlines() if not line.startswith("# mini")
                and not line.startswith("# rendered")]

    assert body(port / "depth.txt") == body(ref / "depth.txt")
    assert body(port / "rgb.txt") == body(ref / "rgb.txt")
    same_camera(ttum.sequence_camera(port), jtum.sequence_camera(ref))
    gt_p, gt_r = (np.array([line.split() for line in body(d / "groundtruth.txt")[1:]], float)
                  for d in (port, ref))
    np.testing.assert_allclose(gt_p, gt_r, atol=1.5e-6, rtol=0)
    for i in range(5):
        tp, tr = ttum.TumSequence(port).frame(i), jtum.TumSequence(ref).frame(i)
        np.testing.assert_array_equal(tp.rgb, tr.rgb)
        dp, dr = (np.nan_to_num(f.depth) / ttum.TUM_DEPTH_SCALE for f in (tp, tr))
        assert np.abs(dp - dr).max() <= 1.01
