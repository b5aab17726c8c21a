"""SLAM at bench scale from files: the port's CLI against the JAX package's,
both on the CPU.

Writes the SLAM bench's textured-room sweep (``sweep_trajectory(n=FRAMES)``
at the bench's field of view) as a TUM sequence with
``perception_tpu_torch/bench/tum_sequence.py``, then runs ``cli slam
--tum DIR --cpu`` of each package in this process at ``SlamConfig()``
(the CLI's configuration) and prints, per package, the CLI's ATE line and
what its ``run_slam`` returned: keyframes, live loop-closure edges, BA runs,
and the wall time. The RANSAC streams differ (``jax.random`` against a
``torch.Generator``), so the two are compared as results, not bits.

Run from the repository root (JAX on the CPU; ``build/`` is ignored by git):
``JAX_PLATFORMS=cpu python3 tools_torch/slam_cli_compare.py --dir build/sweep [--width 640 --height 480 --frames 300]``
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run(name, main, system, argv):
    """Run one CLI with its ``run_slam`` recorded; returns a summary dict."""
    import numpy as np

    seen = []
    real = system.run_slam

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    system.run_slam = spy
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        system.run_slam = real
    seconds = time.perf_counter() - t0
    line = [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")][-1]
    state, _, diags = seen[0]

    def host(x):  # a torch tensor or a JAX array, as numpy
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    loop_edges = int(((host(state.edges.weight) == 2.0) & host(state.edges.mask)).sum())
    return {
        "package": name,
        "ate_cm": line["value"] * 100.0,
        "cli_loop_closures": line["loop_closures"],
        "live_loop_edges": loop_edges,
        "keyframes": int(host(state.keyframes.count)),
        "ba_runs": int(sum(bool(host(d.ba_ran)) for d in diags)),
        "frames": line["frames"],
        "seconds": round(seconds, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="where the TUM sequence is written")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--frames", type=int, default=300)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from perception_tpu.cli import main as jax_main
    from perception_tpu.models.slam import system as jax_system
    from perception_tpu_torch.bench.tum_sequence import make_sequence
    from perception_tpu_torch.cli import main as port_main
    from perception_tpu_torch.models.slam import system as port_system

    make_sequence(args.dir, args.frames, args.width, args.height)
    argv = ["slam", "--tum", args.dir, "--cpu", "--max-frames", str(args.frames)]
    print(f"sweep: {args.frames} frames at {args.width}x{args.height} in {args.dir}", flush=True)
    for name, main_fn, system in (("perception_tpu_torch", port_main, port_system),
                                  ("perception_tpu (JAX)", jax_main, jax_system)):
        print(json.dumps(run(name, main_fn, system, argv)), flush=True)


if __name__ == "__main__":
    main()
