"""Times of the port's CUDA kernels on one card, at the paths' shapes.

    python3 kernel_times.py [CHECKOUT]

For K1 (B=1 and 8 at N=8192, B=1 at 32768 and 24576), K2 (4096 x 8192, 2048 x 4096, 8192 x 32768) and K3+K4
(2048 queries on a 32768-point map, 4096 on 65536), on ``chip_smoke.py``'s
inputs: the eager wrapper call by CUDA events (``ms``), each kernel's mean
device time per launch by torch.profiler (``by_kernel_us``), and the sum of
those of the port's own kernels (``kernels_us``: their device time a call,
each launched once a call). No CUDA graph: PR 3's wrappers copy scalars
from the host and cannot be captured. With CHECKOUT, the
``perception_tpu_torch`` of that directory is timed instead of this
one's (the inputs still come
from this directory's ``chip_smoke.py``), so two commits compare on one
card when the script is run in turns on each (parent, change, change,
parent).

Prints the card and the package timed, then one JSON object per case.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

import chip_smoke

OWN_KERNELS = ("ransac_score", "icp_gn", "voxelhash")  # csrc/*.cu's kernel names start so


def cases(device):
    """(kernel, shape, eager call) at the paths' shapes."""
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query

    out = []
    for b, n in chip_smoke.K1_TIMED:
        pts, mask, hyp = chip_smoke.kernel_inputs(b, n, 1024, False, device, seed=1)
        out.append(("K1", f"B={b} {n}x1024", lambda a=(pts, mask, hyp): ransac_score(*a, chip_smoke.TAU)))
    for r, n, m in ((1, 4096, 8192), (1, 2048, 4096), (1, 8192, 32768)):
        args = chip_smoke.k2_inputs(r, n, m, False, device, seed=1)
        out.append(("K2", f"{n}x{m}", lambda a=args: gn_system_packed(*a, 0.25, 0.02, return_stats=True)))
    for m, nq in ((32768, 2048), (65536, 4096)):
        args, _ = chip_smoke.k3_case(m, nq, "sorted", False, device, seed=1)
        out.append(("K3+K4", f"{nq}q {m}pts", lambda a=args: voxelhash_query(*a)))
    return out


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 1
    if len(sys.argv) == 2:
        sys.path.insert(0, sys.argv[1])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "package": __import__("perception_tpu_torch").__file__}))
    for kernel, shape, fn in cases(device):
        ms = chip_smoke.cuda_ms(fn, 100)  # before the profiler, which slows the host after it
        per = chip_smoke.profile_launches(fn)
        ours = sum(us for name, us in per.items() if name.startswith(OWN_KERNELS))
        print(json.dumps({"kernel": kernel, "shape": shape, "ms": ms, "kernels_us": ours,
                          "by_kernel_us": per}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
