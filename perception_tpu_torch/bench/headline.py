"""The headline benchmark: cuboid-ICP pipeline frames/s at 640x480.

Counterpart of the repository's root ``bench.py`` (what the JAX CLI's
``bench`` runs); ``python -m perception_tpu_torch.cli bench`` runs
``main``. It prints one JSON line last:

  {"metric": "cuboid_icp_frames_per_sec_per_chip_640x480", "value": N,
   "unit": "frames/s", "vs_baseline": N, "extra": {...}}

value        frames/s of the whole cuboid pipeline (decimate + backproject
             -> passthrough -> voxel -> RANSAC plane -> multi-restart
             template ICP) on the device, the best of B = 1, 2, 4, 8: the
             8 bench frames (``bench/scene.py``, seeds 0-7) staged on the
             device, each B the median of ``REPEATS`` timed passes after a
             warm pass (host clock, ending in a synchronize on the card)
vs_baseline  value / the measured CPU frames/s of
             ``bench/cpu_baseline.measure_cpu_fps`` (numpy + scipy's
             cKDTree, the PCL-equivalent harness; a copy of
             ``benchmarks/cpu_baseline.py``)
extra        ``bench.py``'s keys: the CPU baseline's runs, the fps-vs-batch
             curve and its spreads, the SLAM rows (``bench/slam_bench.py``:
             keyframe mode with BA and without, map fusion at 32768), the
             object tracker (``bench/tracking_bench.py``), the facade
             (``bench/facade_bench.py``) and the nearest-neighbour
             crossover (``bench/nn_crossover.py``)

Progress lines go to stderr, as ``bench.py`` prints them.

One deliberate difference from ``bench.py``: there a failing extra becomes
an ``*_error`` key and the run still exits 0. Here the exception
propagates, so a run with a failed extra exits non-zero and prints no
line: a failure on the card must not hide behind a headline number.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import sync

METRIC = "cuboid_icp_frames_per_sec_per_chip_640x480"
REPEATS = 3
FRAMES = 8           # bench frames, seeds 0-7
TIMED_FRAMES = 96    # frames a timed pass
SLAM_FRAMES = 300    # the SLAM rows' revisit sweep
TRACKING_FRAMES = 300
FACADE_FRAMES = 120
BATCHES = (1, 2, 4, 8)
BLOCKS = 4           # staged blocks a batch size cycles through
NN_SIZES = [(4096, 8192), (4096, 32768), (16384, 131072), (307200, 32768)]
SLAM_KEYS = ("ate_cm", "slam_fps", "loop_closures", "pose_graph_corrections", "keyframes", "ba_runs",
             "landmarks", "observations")
CPU_BASELINE_NOTE = (
    "measured numpy/scipy cKDTree harness (PCL-equivalent), "
    "not PCL itself — see benchmarks/cpu_baseline.py; median of "
    "3 passes over 8 frames"
)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _rounded(d: dict) -> dict:
    return {k: (round(v, 3) if isinstance(v, float) else v) for k, v in d.items()}


def _timed_fps(dispatch, n_items: int, repeats: int = REPEATS):
    """Median frames/s of ``dispatch()`` (which runs n_items frames and
    waits for them): one warm pass, then ``repeats`` timed passes. Returns
    (median, spread % of the median, the passes' frames/s)."""
    dispatch()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        dispatch()
        runs.append(n_items / (time.perf_counter() - t0))
    med = float(np.median(runs))
    return med, 100.0 * (max(runs) - min(runs)) / med, [round(r, 2) for r in runs]


def run(timed_frames: int = TIMED_FRAMES, batches=BATCHES, repeats: int = REPEATS, slam_frames: int = SLAM_FRAMES,
        tracking_frames: int = TRACKING_FRAMES, facade_frames: int = FACADE_FRAMES, nn_sizes=NN_SIZES,
        device="cuda") -> dict:
    """The benchmark's line as a dict; the defaults are ``bench.py``'s."""
    from perception_tpu_torch.bench import facade_bench, nn_crossover, slam_bench, tracking_bench
    from perception_tpu_torch.bench.cpu_baseline import measure_cpu_fps
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_batch,
        cuboid_pipeline_from_depth,
        template_features,
    )

    device = torch.device(device)
    camera = PinholeCamera.d435_depth()
    template_np = benchmark_template()
    config = CuboidConfig()
    # Session-constant template preprocessing (pipeline resolution + normals).
    template, tnormals, template_mask = template_features(template_np, np.ones(len(template_np), bool), config,
                                                          device=device)
    frames, _ = bench_frames(camera, range(FRAMES))
    dev_frames = torch.from_numpy(frames).to(device)

    def one(depth, gen):
        return cuboid_pipeline_from_depth(depth, camera, template, template_mask, gen, config,
                                          template_normals=tnormals)

    def block(depths, gen):
        return cuboid_pipeline_batch(depths, camera, template, template_mask, gen, config,
                                     template_normals=tnormals)

    res = one(dev_frames[0], torch.Generator(device=device).manual_seed(0))
    _log(f"warmup: accepted={bool(res.accepted)} fitness={float(res.fitness):.6f}")

    fps_vs_batch, spread_vs_batch = {}, {}
    for B in batches:
        if B == 1:
            # One generator a timed frame, made before the clock starts.
            gens = [torch.Generator(device=device).manual_seed(i) for i in range(timed_frames)]

            def dispatch():
                out = None
                for i in range(timed_frames):
                    out = one(dev_frames[i % FRAMES], gens[i])
                sync(out)

            n_items = timed_frames
        else:
            blocks = [torch.stack([dev_frames[(i * B + j) % FRAMES] for j in range(B)]) for i in range(BLOCKS)]
            gens = [torch.Generator(device=device).manual_seed(100 + i) for i in range(BLOCKS)]
            sync(block(blocks[0], gens[0]))
            n_blocks = max(2, timed_frames // B)

            def dispatch():
                out = None
                for i in range(n_blocks):
                    out = block(blocks[i % BLOCKS], gens[i % BLOCKS])
                sync(out)

            n_items = n_blocks * B
        fps, spread, runs = _timed_fps(dispatch, n_items, repeats)
        fps_vs_batch[B], spread_vs_batch[B] = fps, round(spread, 1)
        _log(f"{device.type}: {fps:.2f} frames/s batch-{B} (spread {spread:.1f}%, {runs})")

    best_batch = max(fps_vs_batch, key=fps_vs_batch.get)
    value = fps_vs_batch[best_batch]

    cpu_fps, cpu_runs = measure_cpu_fps(frames, camera, template_np)
    _log(f"cpu baseline: {cpu_fps:.3f} frames/s (median of {cpu_runs})")

    extra = {
        "cpu_baseline_note": CPU_BASELINE_NOTE,
        "cpu_baseline_runs": [round(r, 3) for r in cpu_runs],
        "fps_vs_batch": {str(k): round(v, 2) for k, v in fps_vs_batch.items()},
        "fps_spread_pct_vs_batch": {str(k): v for k, v in spread_vs_batch.items()},
        "headline_batch": best_batch,
    }

    # SLAM over the 300-frame revisit sweep: keyframe mode with BA, without
    # BA, and map fusion at 32768 points.
    slam = slam_bench.run(frames=slam_frames, enable_ba=True, device=device)
    extra.update(_rounded({k: slam[k] for k in SLAM_KEYS}))
    extra["slam_frames"] = slam["frames"]
    extra["slam_resolution"] = slam["resolution"]
    _log(f"slam(BA): ate={slam['ate_cm']:.2f} cm, {slam['slam_fps']:.1f} fps, "
         f"{slam['loop_closures']} loop closures, {slam['ba_runs']} BA runs")

    no_ba = slam_bench.run(frames=slam_frames, enable_ba=False, device=device)
    extra["ate_cm_no_ba"] = round(no_ba["ate_cm"], 3)
    extra["slam_fps_no_ba"] = round(no_ba["slam_fps"], 3)
    _log(f"slam(no BA): ate={no_ba['ate_cm']:.2f} cm, {no_ba['slam_fps']:.1f} fps")

    mm = slam_bench.run(frames=slam_frames, enable_ba=True, map_budget=32768, device=device)
    extra["map_mode"] = _rounded({k: mm[k] for k in ("ate_cm", "slam_fps", "map_budget", "keyframes")})
    _log(f"slam(map 32k): ate={mm['ate_cm']:.2f} cm, {mm['slam_fps']:.1f} fps")

    tr = tracking_bench.run(frames=tracking_frames, device=device)
    extra["objects_tracking"] = _rounded(tr)
    _log(f"tracking: {tr['tracking_fps']:.1f} fps, median err {tr['median_err_cm']:.2f} cm, "
         f"latched {tr['latched_pct']:.0f}%, warm {tr['warm_pct']:.0f}%")

    fb = facade_bench.run(frames=facade_frames, device=device)
    extra["facade"] = _rounded(fb)
    _log(f"facade: {fb['facade_fps']:.1f} fps ({fb['extractors']}, {fb['faces_tracked']} faces, "
         f"{fb['resolution']})")

    extra["nn_crossover"] = nn_crossover.measure(sizes=nn_sizes, device=device)

    return {
        "metric": METRIC,
        "value": round(value, 3),
        "unit": "frames/s",
        "vs_baseline": round(value / cpu_fps, 3),
        "extra": extra,
    }


def main(device="cuda") -> None:
    """Run the benchmark on ``device`` and print its line."""
    print(json.dumps(run(device=device)), flush=True)
