"""The port's ``cli bench`` (``bench/headline.py``) against the root
``bench.py``, on the CPU.

``bench.py`` is not run here (its full sizes take hours on a CPU); its
line's keys are read from its source: the top-level keys of the dict it
prints, and ``extra``'s keys (the dict literal, each ``extra["..."] =``
other than the ``*_error`` keys the port does not write, and the SLAM
keys of its ``for k in (...)`` loop), with ``map_mode``'s keys.

One ``cli.main(["bench", "--cpu"])`` runs in this module, with
``headline.run`` cut small (2 frames a timed pass, batches 1 and 2, 1
repeat, 3 SLAM frames, 2 tracker frames, 2 facade frames, one 512 x 4096
NN size) and ``measure_cpu_fps`` over 2 frames and 1 repeat (its result
recorded). Held exactly: the keys; the last stdout line is the one JSON
line; ``headline_batch`` has the largest of ``fps_vs_batch`` and
``value`` is its frames/s (fps_vs_batch rounds to 2 decimals, value to 3:
within 0.005 + 0.0005); ``vs_baseline`` is value / the CPU median (both
rounded to 3 decimals: within 0.0005 + the value's rounding over the
median, + 1e-9 for the float sum); with both TF32 flags set True by
the caller, every convolution of the run sees them False and ``cli.main``
leaves them True; the kernels' launch counts, total and by shape, do not
move (CPU tensors take the plain versions). No module of the port imports
``jax``, ``flax``, ``optax``, the JAX package or ``benchmarks``: the CPU
baseline is the port's own copy (``bench/cpu_baseline.py``), whose
``cuboid_pipeline_cpu`` gives ``benchmarks/cpu_baseline.py``'s pose and
fitness on bench frame 0. The port's 8 bench frames equal
``benchmarks/scene.py``'s bit for bit. A failing extra propagates its
exception and prints no line (``bench.py`` writes an ``*_error`` key
instead).
"""

import ast
import contextlib
import functools
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import cpu_baseline as jax_cpu_baseline
from benchmarks import scene as jscene
from perception_tpu.geometry.camera import PinholeCamera as JaxCamera
from perception_tpu_torch import cli
from perception_tpu_torch.bench import cpu_baseline, headline
from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
from perception_tpu_torch.geometry.camera import PinholeCamera

REPO = Path(__file__).resolve().parents[1]
JAX_ONLY = ("jax", "jaxlib", "flax", "optax", "orbax", "perception_tpu", "benchmarks")
SMALL = dict(timed_frames=2, batches=(1, 2), repeats=1, slam_frames=3, tracking_frames=2, facade_frames=2,
             nn_sizes=[(512, 4096)])

torch.set_num_threads(2)


def bench_py_keys():
    """(top-level keys, extra keys, map_mode keys) of bench.py's line, from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    top, extra, map_mode = set(), set(), set()

    def str_keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and "metric" in str_keys(node):
            top = str_keys(node)
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "extra" and isinstance(node.value, ast.Dict):
                extra |= str_keys(node.value)
            if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                    and target.value.id == "extra" and isinstance(target.slice, ast.Constant)):
                extra.add(target.slice.value)
                if target.slice.value == "map_mode":
                    map_mode = str_keys(node.value)
        if (isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple)
                and any(isinstance(s, ast.Assign) and isinstance(s.targets[0], ast.Subscript)
                        and isinstance(s.targets[0].value, ast.Name) and s.targets[0].value.id == "extra"
                        for s in node.body)):
            extra |= {e.value for e in node.iter.elts}
    return top, {k for k in extra if not k.endswith("_error")}, map_mode


@pytest.fixture(scope="module")
def bench_run():
    """One small ``cli bench --cpu``: (stdout, stderr, the CPU baseline's
    (median, runs), (the TF32 flags each convolution saw, the flags after
    the call), the kernels' launch counts (total, by shape) before and
    after the call)."""
    seen, conv_flags = [], []
    conv2d = torch.nn.functional.conv2d

    def spy_conv2d(*args, **kwargs):
        conv_flags.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return conv2d(*args, **kwargs)

    def measure_cpu_fps(frames, camera, template):
        seen.append(real(frames, camera, template, max_frames=2, repeats=1))
        return seen[-1]

    real = cpu_baseline.measure_cpu_fps
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cpu_baseline, "measure_cpu_fps", measure_cpu_fps)
        mp.setattr(headline, "run", functools.partial(headline.run, **SMALL))
        mp.setattr(torch.nn.functional, "conv2d", spy_conv2d)
        mp.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        mp.setattr(torch.backends.cudnn, "allow_tf32", True)
        before = launch_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(["bench", "--cpu"])
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    return out.getvalue(), err.getvalue(), seen[0], (conv_flags, flags), (before, launch_counts())


def launch_counts():
    """Each kernel wrapper's (launches, launches by shape)."""
    from perception_tpu_torch.ops.kernels import icp_gn, ransac_score, voxelhash_query

    return [(w.launches, dict(w.launches_by_shape))
            for w in (ransac_score.ransac_score, icp_gn.gn_system_packed, voxelhash_query.voxelhash_query)]


def line(bench_run):
    return json.loads(bench_run[0].strip().splitlines()[-1])


def test_prints_one_json_line_last(bench_run):
    stdout, stderr, *_ = bench_run
    lines = stdout.strip().splitlines()
    assert lines and all(not s.startswith("{") for s in lines[:-1])
    assert line(bench_run)["metric"] == "cuboid_icp_frames_per_sec_per_chip_640x480"
    for progress in ("warmup: accepted=", "cpu: ", "batch-1", "batch-2", "cpu baseline:", "slam(BA):",
                     "slam(no BA):", "slam(map 32k):", "tracking:", "facade:"):
        assert progress in stderr, progress


def test_top_level_keys_equal_bench_py(bench_run):
    top, _, _ = bench_py_keys()
    assert top == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert set(line(bench_run)) == top


def test_extra_keys_equal_bench_py(bench_run):
    _, extra, map_mode = bench_py_keys()
    got = line(bench_run)["extra"]
    assert set(got) == extra
    assert set(got["map_mode"]) == map_mode
    assert not any(k.endswith("_error") for k in got)
    assert set(got["fps_vs_batch"]) == set(got["fps_spread_pct_vs_batch"]) == {"1", "2"}
    assert got["slam_frames"] == 3 and got["slam_resolution"] == "640x480"
    assert got["map_mode"]["map_budget"] == 32768
    assert got["facade"]["faces_tracked"] == 3 and got["objects_tracking"]["frames"] == 2
    assert [(r["nq"], r["m"]) for r in got["nn_crossover"]] == [(512, 4096)]


def test_value_is_the_best_batch(bench_run):
    out = line(bench_run)
    fps = out["extra"]["fps_vs_batch"]
    best = str(out["extra"]["headline_batch"])
    assert fps[best] == max(fps.values())  # rounding keeps the order, ties aside
    assert abs(out["value"] - fps[best]) <= 0.0055
    assert out["unit"] == "frames/s" and out["value"] > 0


def test_vs_baseline_is_value_over_the_cpu_median(bench_run):
    out = line(bench_run)
    cpu_median, cpu_runs = bench_run[2]
    assert out["extra"]["cpu_baseline_runs"] == [round(r, 3) for r in cpu_runs]
    assert abs(out["vs_baseline"] - out["value"] / cpu_median) <= 0.0005 + 0.0005 / cpu_median + 1e-9


def test_cli_main_switches_tf32_off(bench_run):
    """Off inside every convolution (the facade's nets), the caller's
    setting after the call: no process-global switch."""
    conv_flags, after = bench_run[3]
    assert conv_flags and set(conv_flags) == {(False, False)}
    assert after == (True, True)


def test_cpu_tensors_count_no_launch(bench_run):
    """On the CPU every wrapper takes its plain version, which no count
    sees: neither the totals nor the counts by shape move."""
    before, after = bench_run[4]
    assert after == before


def test_the_port_imports_no_jax_and_benchmarks_only_on_use():
    """Neither at import time nor on use: the port imports nothing of the
    JAX package or of ``benchmarks``."""
    for path in sorted((REPO / "perception_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in JAX_ONLY, f"{path}: imports {name}"


def test_cpu_baseline_copy_equals_benchmarks():
    """The port's CPU baseline gives the JAX benchmark's pose and fitness
    on bench frame 0, so ``vs_baseline`` keeps its yardstick."""
    camera = PinholeCamera.d435_depth()
    depths, _ = bench_frames(camera, range(1))
    fx, fy, cx, cy = (float(v) for v in (camera.fx, camera.fy, camera.cx, camera.cy))
    vv, uu = np.meshgrid(np.arange(depths.shape[1]), np.arange(depths.shape[2]), indexing="ij")
    z = depths[0]
    valid = np.isfinite(z) & (z > 0.05) & (z < 10.0)
    cloud = np.stack([((uu - cx) / fx * z)[valid], ((vv - cy) / fy * z)[valid], z[valid]], -1).astype(np.float32)
    template = benchmark_template()
    got = cpu_baseline.cuboid_pipeline_cpu(cloud, template)
    want = jax_cpu_baseline.cuboid_pipeline_cpu(cloud, template)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and np.isfinite(got[1])


def test_bench_frames_equal_the_jax_benchmarks():
    depths, _ = bench_frames(PinholeCamera.d435_depth(), range(headline.FRAMES))
    for s in range(headline.FRAMES):
        want = jscene.render_depth_tabletop(JaxCamera.d435_depth(), seed=s,
                                            cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * s))
        np.testing.assert_array_equal(depths[s], want)


def test_a_failing_extra_propagates(monkeypatch):
    from perception_tpu_torch.bench import slam_bench

    def broken(**kwargs):
        raise RuntimeError("slam broke")

    monkeypatch.setattr(slam_bench, "run", broken)
    monkeypatch.setattr(cpu_baseline, "measure_cpu_fps", lambda *a: (1.0, [1.0]))
    monkeypatch.setattr(headline, "run", functools.partial(headline.run, **dict(SMALL, batches=(1,))))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(RuntimeError, match="slam broke"):
            headline.main("cpu")
    assert out.getvalue() == ""
