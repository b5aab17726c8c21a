"""Per-extractor facade latency breakdown on the card.

Counterpart of ``benchmarks/facade_profile.py``: the ``Perception``
wrapper with each extractor subset on (pose only, face only, pose+hands,
all on), timed on the same 256x256 three-face scene as
``bench/facade_bench.py`` (its ``make_engine`` and ``staged_frames``: 8
renders staged on the device beforehand), so the all-on number
decomposes into its stages. Each subset: one warm-up call, then
``frames`` calls of ``emplace_and_pop`` by the host clock, ending in a
synchronize on each output the subset makes. One JSON line a subset:

  config        the subset's name
  ms_per_frame  ms a frame, rounded to 2 decimals
  fps           frames/s, rounded to 1 decimal

Run: ``python -m perception_tpu_torch.bench.facade_profile [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from perception_tpu_torch.bench.timing import device_of, sync

FRAMES = 60
HW = (256, 256)
SUBSETS = (
    ("pose only", dict(pose=True)),
    ("face only", dict(face=True)),
    ("pose+hands", dict(pose=True, hand=True)),
    ("all on", dict(pose=True, face=True, hand=True)),
)


def _outputs(datum):
    """The tensors the subset computed: keypoints, face and hand landmarks."""
    return [t for t in (getattr(datum.people, "keypoints", None) if datum.people else None,
                        datum.faces["landmarks"] if datum.faces else None,
                        datum.hands["landmarks"] if datum.hands else None) if t is not None]


def time_engine(pose=False, face=False, hand=False, frames=FRAMES, hw=HW, device="cuda") -> float:
    """ms a frame of ``Perception`` with the given extractors on."""
    from perception_tpu_torch.bench.facade_bench import STAGED, make_engine, staged_frames

    device = device_of(device)
    engine = make_engine(pose, face, hand, device)
    imgs = torch.from_numpy(staged_frames(hw)).to(device)
    sync(imgs)
    sync(_outputs(engine.emplace_and_pop(imgs[0], frame_index=0)))
    t0 = time.perf_counter()
    last = None
    for t in range(frames):
        last = engine.emplace_and_pop(imgs[t % STAGED], frame_index=t + 1)
    sync(_outputs(last))
    return 1000.0 * (time.perf_counter() - t0) / frames


def run(frames: int = FRAMES, hw=HW, device="cuda") -> list:
    """One row a subset, each printed as a JSON line as it is measured."""
    rows = []
    for name, kw in SUBSETS:
        ms = time_engine(**kw, frames=frames, hw=hw, device=device)
        row = {"config": name, "ms_per_frame": round(ms, 2), "fps": round(1000.0 / ms, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    run(device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
