"""The port's command line against the JAX package's, on the CPU.

* ``--help`` lists the six subcommands, run as ``python -m
  perception_tpu_torch.cli`` with ``jax``, the JAX package and
  ``benchmarks`` hidden;
  without a card and without ``--cpu`` the CLI stops with a message.
* ``cuboid --cpu`` on a bench frame written as a 16-bit mm PNG, with the
  template as a binary PCD: accepted, translation within 2 cm of ground
  truth.
* ``odometry --tum tests/fixtures/tum_mini --cpu --max-frames 8`` against
  the JAX CLI's, both read from ``--out``: translations within 5e-5 m and
  quaternion components within 5e-5 (the files round to 1e-6; the two
  odometries agree to ~1e-5 m), ATE within 1e-5 m.
* ``slam --tum tests/fixtures/tum_mini --cpu --max-frames 6`` against the
  JAX CLI's: the RANSAC streams differ (``torch.Generator`` against
  ``jax.random``), so results are compared, not bits: the same keyframe
  count and loop closures, ATE within 1 mm, poses within 5 mm.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perception_tpu.cli import main as jax_main
from perception_tpu.io.tum import read_trajectory as jax_read_trajectory
from perception_tpu.models.slam import system as jax_system
from perception_tpu_torch import cli
from perception_tpu_torch.io.tum import read_trajectory
from perception_tpu_torch.models.slam import system

REPO = Path(__file__).resolve().parents[1]
TUM_MINI = REPO / "tests" / "fixtures" / "tum_mini"

HIDE_JAX = """
import runpy, sys
class Hide:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "perception_tpu", "benchmarks"):
            raise ImportError(f"{name} is hidden")
sys.meta_path.insert(0, Hide())
sys.argv = ["perception_tpu_torch.cli", "--help"]
runpy.run_module("perception_tpu_torch.cli", run_name="__main__")
"""


def json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_help_lists_the_subcommands_with_jax_hidden():
    proc = subprocess.run([sys.executable, "-c", HIDE_JAX], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for cmd in ("cuboid", "objects", "odometry", "slam", "pose", "bench"):
        assert cmd in proc.stdout


def test_without_a_card_the_cli_asks_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        cli.main(["odometry", "--tum", str(TUM_MINI)])


def test_cuboid_from_png_and_pcd(tmp_path, capsys):
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.io.pcd import write_pcd
    from perception_tpu_torch.io.png import write_png

    depths, gts = bench_frames(PinholeCamera.d435_depth(), [3])
    write_png(tmp_path / "depth.png", np.clip(depths[0] * 1000.0, 0, 65535).astype(np.uint16))
    write_pcd(tmp_path / "t.pcd", benchmark_template(), binary=True)
    cli.main(["cuboid", "--cpu", "--depth", str(tmp_path / "depth.png"), "--depth-scale", "0.001",
              "--template", str(tmp_path / "t.pcd")])
    out = json_lines(capsys.readouterr().out)[-1]
    assert out["accepted"] is True
    assert np.linalg.norm(np.asarray(out["pose"])[:3, 3] - gts[0][:3, 3]) < 0.02
    assert np.asarray(out["bbox"]).shape == (8, 3) and out["num_box_points"] > 0


def test_odometry_matches_the_jax_cli(tmp_path, capsys):
    args = ["odometry", "--tum", str(TUM_MINI), "--cpu", "--max-frames", "8"]
    cli.main(args + ["--out", str(tmp_path / "port.txt")])
    port = json_lines(capsys.readouterr().out)
    jax_main(args + ["--out", str(tmp_path / "jax.txt")])
    ref = json_lines(capsys.readouterr().out)

    ts, poses = read_trajectory(tmp_path / "port.txt")
    jts, jposes = jax_read_trajectory(tmp_path / "jax.txt")
    np.testing.assert_array_equal(ts, jts)
    assert poses.shape == (8, 4, 4)
    np.testing.assert_allclose(poses[:, :3, 3], jposes[:, :3, 3], atol=5e-5, rtol=0)
    quats = [np.loadtxt(tmp_path / f"{name}.txt")[:, 4:] for name in ("port", "jax")]
    np.testing.assert_allclose(quats[0], quats[1], atol=5e-5, rtol=0)
    assert [r["frame"] for r in port[:-1]] == [r["frame"] for r in ref[:-1]] == list(range(1, 8))
    assert [r["promoted"] for r in port[:-1]] == [r["promoted"] for r in ref[:-1]]
    assert port[-1]["metric"] == ref[-1]["metric"] == "ate_rmse_m" and port[-1]["frames"] == 8
    assert abs(port[-1]["value"] - ref[-1]["value"]) < 1e-5


def spy(monkeypatch, module):
    """Record what ``module.run_slam`` returns (the CLIs import it on use)."""
    seen = []
    real = module.run_slam

    def run_slam(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, "run_slam", run_slam)
    return seen


def test_slam_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    args = ["slam", "--tum", str(TUM_MINI), "--cpu", "--max-frames", "6"]
    port_runs, jax_runs = spy(monkeypatch, system), spy(monkeypatch, jax_system)
    cli.main(args + ["--out", str(tmp_path / "port.txt")])
    port = json_lines(capsys.readouterr().out)[-1]
    jax_main(args + ["--out", str(tmp_path / "jax.txt")])
    ref = json_lines(capsys.readouterr().out)[-1]

    assert port["frames"] == ref["frames"] == 6
    assert port["loop_closures"] == ref["loop_closures"]
    assert abs(port["value"] - ref["value"]) < 1e-3
    assert int(port_runs[0][0].keyframes.count) == int(jax_runs[0][0].keyframes.count)
    _, poses = read_trajectory(tmp_path / "port.txt")
    _, jposes = jax_read_trajectory(tmp_path / "jax.txt")
    np.testing.assert_allclose(poses[:, :3, 3], jposes[:, :3, 3], atol=5e-3, rtol=0)
