"""Write the mini TUM-format fixture sequence, with the port.

Counterpart of ``tools/make_tum_fixture.py``, with its flags: ``--frames``
(30), ``--width`` (160), ``--height`` (120) and ``--out``. The textured
room (``bench/slam_scene.render_textured_room``) seen along
``sweep_trajectory(n=frames)`` by the SLAM bench's camera (fx = 307 *
width / 320), written in the TUM format: ``rgb/`` (8-bit RGB, the gray
replicated) and ``depth/`` (16-bit at 5000 counts/m) PNGs through
``io/png`` (no cv2), ``rgb.txt``, ``depth.txt``, ``groundtruth.txt`` at 30
Hz from 1000 s, and the repo's ``calibration.txt`` extension. The files'
text, the JAX tool's header included, and the decoded pixels are those of
the JAX tool's output. ``--out`` defaults to ``build/tum_mini``: the
committed ``tests/fixtures/tum_mini`` is replaced only when ``--out`` names
it (the JAX tool writes there by default).

Usage: ``python3 tools_torch/make_tum_fixture.py [--frames 30] [--width 160]
[--height 120] [--out DIR]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HEADER = "# mini rendered TUM-format fixture (tools/make_tum_fixture.py)\n"  # the committed fixture's


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--out", default=str(ROOT / "build" / "tum_mini"))
    args = ap.parse_args(argv)

    from perception_tpu_torch.bench.tum_sequence import make_sequence

    out = make_sequence(args.out, args.frames, args.width, args.height, header=HEADER)
    total_kb = sum(p.stat().st_size for p in out.rglob("*") if p.is_file()) / 1024
    print(f"wrote {args.frames} frames to {out} ({total_kb:.0f} KB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
