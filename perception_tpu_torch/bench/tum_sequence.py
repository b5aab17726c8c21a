"""Write the textured-room sweep as a TUM RGB-D sequence directory.

Counterpart of ``tools/make_tum_fixture.py``, through the port's PNG
writer (``io/png.py``) instead of OpenCV: ``rgb/`` (8-bit RGB, the gray
replicated), ``depth/`` (16-bit PNG at 5000 counts/m), ``rgb.txt``,
``depth.txt``, ``groundtruth.txt`` (``t tx ty tz qx qy qz qw``) at 30 Hz
timestamps from 1000 s, and the repo's ``calibration.txt`` extension
(``fx fy cx cy width height``), at any size. ``io/tum.TumSequence`` and
``cli odometry|slam --tum DIR`` read it back.

Usage: ``python -m perception_tpu_torch.bench.tum_sequence --out DIR
[--frames 30] [--width 160] [--height 120]``
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from perception_tpu_torch.bench.slam_bench import bench_camera
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.io.png import write_png
from perception_tpu_torch.io.tum import TUM_DEPTH_SCALE, trajectory_text

HEADER = "# rendered TUM-format sequence (perception_tpu_torch/bench/tum_sequence.py)\n"


def _stamp(i: int) -> float:
    return 1000.0 + i / 30.0  # 30 Hz timestamps


def write_tum_sequence(out, camera, trajectory, render=None, threads: int = 8, header: str = HEADER) -> Path:
    """Write frame i of ``trajectory`` (world <- camera poses) as seen by
    ``camera``; ``render(i)`` gives its (gray, depth) float32 images
    (default: ``render_textured_room`` with seed i). Frames are rendered
    and encoded on ``threads`` threads; ``header`` heads the three lists.
    Returns the directory."""
    out = Path(out)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    render = render or (lambda i: render_textured_room(camera, trajectory[i], seed=i))

    def frame(i):
        gray, depth = render(i)
        t = _stamp(i)
        d16 = np.clip(depth / TUM_DEPTH_SCALE, 0, 65535).astype(np.uint16)
        write_png(out / f"depth/{t:.6f}.png", d16)
        g8 = np.clip(gray, 0, 255).astype(np.uint8)
        write_png(out / f"rgb/{t:.6f}.png", np.stack([g8, g8, g8], axis=-1))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(frame, range(len(trajectory))))  # reads every result: a failure raises here

    times = [_stamp(i) for i in range(len(trajectory))]
    listing = "# timestamp filename\n"
    (out / "depth.txt").write_text(header + listing + "".join(f"{t:.6f} depth/{t:.6f}.png\n" for t in times))
    (out / "rgb.txt").write_text(header + listing + "".join(f"{t:.6f} rgb/{t:.6f}.png\n" for t in times))
    (out / "groundtruth.txt").write_text(
        header + "# timestamp tx ty tz qx qy qz qw\n" + trajectory_text(times, trajectory))
    (out / "calibration.txt").write_text(
        f"# fx fy cx cy width height\n{camera.fx} {camera.fy} {camera.cx} {camera.cy} "
        f"{camera.width} {camera.height}\n")
    return out


def make_sequence(out, frames: int = 30, width: int = 160, height: int = 120, threads: int = 8,
                  header: str = HEADER) -> Path:
    """The sweep of ``frames`` poses (``sweep_trajectory(n=frames)``) at
    the SLAM bench's field of view, rendered and written."""
    return write_tum_sequence(out, bench_camera(width, height), sweep_trajectory(n=frames),
                              threads=threads, header=header)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    args = ap.parse_args(argv)
    out = make_sequence(args.out, args.frames, args.width, args.height)
    total_kb = sum(p.stat().st_size for p in out.rglob("*") if p.is_file()) / 1024
    print(f"wrote {args.frames} frames to {out} ({total_kb:.0f} KB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
