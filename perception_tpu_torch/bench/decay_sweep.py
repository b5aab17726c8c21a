"""Map-mode recency-decay sweep: frames/s and ATE against ``map_decay``.

Counterpart of ``benchmarks/decay_sweep.py``: each row is a full 300-frame
640x480 SLAM run (BA on, a 32k map) through ``bench/slam_bench.run`` with
only odometry's ``map_decay`` varied: 1.0 (the baseline), 0.5 and 0.25, or
the decays given on the command line. One JSON line a row, the JAX
script's keys:

  config     "decay=<d>" ("decay=1.0 (baseline)" for the default sweep's first)
  fps        SLAM frames/s, rounded to 1 decimal
  ate_cm     ATE in cm, rounded to 3 decimals
  keyframes  keyframes at the end

``run`` returns each row beside the SLAM benchmark's whole result (loop
closures, BA runs and the rest), which the tests and ``chip_smoke.py``
hold. Map mode's ATE on this sweep is bimodal under rounding (two values
about 0.06 cm apart at decay 1.0), so a row is held to a range, never to
one value.

Run: ``python -m perception_tpu_torch.bench.decay_sweep [DECAY ...] [--cpu]``
"""

from __future__ import annotations

import argparse
import json

from perception_tpu_torch.bench.timing import device_of

FRAMES = 300
MAP_BUDGET = 32768
CONFIGS = (
    ("decay=1.0 (baseline)", dict()),
    ("decay=0.5", dict(map_decay=0.5)),
    ("decay=0.25", dict(map_decay=0.25)),
)


def configs(decays=None):
    """The default sweep, or one row a given decay (named as given: the
    command line's "0.5" gives "decay=0.5")."""
    if not decays:
        return list(CONFIGS)
    return [(f"decay={v}", dict(map_decay=float(v))) for v in decays]


def run(decays=None, frames: int = FRAMES, device="cuda", **bench_kwargs) -> list:
    """[(row, slam_bench result)] a configuration, each row printed as a
    JSON line as it is measured. ``bench_kwargs`` go to ``slam_bench.run``
    (its frame size)."""
    from perception_tpu_torch.bench.slam_bench import run as slam_run

    device = device_of(device)
    out = []
    for name, kw in configs(decays):
        r = slam_run(frames=frames, enable_ba=True, map_budget=MAP_BUDGET, device=device, **bench_kwargs, **kw)
        row = {"config": name, "fps": round(r["slam_fps"], 1), "ate_cm": round(r["ate_cm"], 3),
               "keyframes": r.get("keyframes")}
        print(json.dumps(row), flush=True)
        out.append((row, r))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("decays", nargs="*", help="map_decay values (default 1.0, 0.5, 0.25)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    run(args.decays, device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
