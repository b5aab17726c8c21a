"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at its own load, then the numbers compared twice over the
same sample: against the plain reference in float32 (the program's
readings, whose largest over the seeds is a limit's lower reading), and
with the reference itself in the program's place, computed with TF32
operands in every matrix product (the control, whose smallest is the
upper reading), and where the cell has one, a rounding baseline of the
reference against itself (``ulp_baseline``). Prints one JSON
line a seed. Needs a CUDA card; the
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # The checkout's root, in place of this script's folder, whose module
    # names (trace, ...) would shadow the standard library's.
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402
from perfbench.reference.common import Precision  # noqa: E402
from perfbench.systems.record import Window  # noqa: E402


def readings(name: str, seed: int, seconds: float, device, edit=None) -> dict:
    import importlib

    _, _, config, traffic = harness.cell_spec(name)
    if edit is not None:
        edit(config, traffic)
    system = importlib.import_module(f"perfbench.systems.{config['system']}")
    sut = system.Cell(config, traffic, seed, device)
    sut.setup()
    rec = Window()
    sut.window(seconds, rec)
    sut.release()
    program, compared = sut.check(Precision("float32"))
    detail = getattr(sut, "detail", None)
    control, _ = sut.check(Precision("tf32"))
    out = {"seed": seed, "units": rec.units, "compared": compared, "program": program, "control": control,
           "worst": detail}
    if hasattr(sut, "ulp_baseline"):
        out["ulp"], out["ulp_worst"] = sut.ulp_baseline()
    return out


def main():
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    harness.configure_caches()
    for seed in a.seeds:
        t = time.perf_counter()
        r = readings(a.workload, seed, a.seconds, torch.device("cuda", 0))
        r["s"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
