"""Times of the port's CUDA kernels on one card, at the paths' shapes.

    python3 kernel_times.py [CHECKOUT]

For K1 (B=1 and 8 at N=8192, B=1 at 32768 and 24576), K2 (4096 x 8192, 2048 x 4096, 8192 x 32768) and K3+K4
(2048 queries on a 32768-point map, 4096 on 65536), on ``chip_smoke.py``'s
inputs: the eager wrapper call by CUDA events (``ms``), each kernel's mean
device time per launch by torch.profiler (``by_kernel_us``), and the sum of
those of the port's own kernels (``kernels_us``: their device time a call,
each launched once a call). For K1 also its bound and issue-rate floor
(``chip_smoke.k1_floor_ms``) and its launch plan where the package has one.
No CUDA graph: the wrappers of older checkouts copy scalars from the
host and cannot be captured. Then each kernel's ptxas report (registers,
spills), and the SLAM system's stage times
(``chip_smoke.slam_stage_times``, median ms of a tracking and of a
promotion frame, BA among them) over the first ``BA_FRAMES`` frames of
the 640x480 sweep in keyframe+BA K2. With
CHECKOUT, the ``perception_tpu_torch`` of that directory is timed instead
of this one's (the inputs still come from this directory's
``chip_smoke.py``), so two commits compare on one card when the script is
run in turns on each (parent, change, change, parent).

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
BA_FRAMES = 100  # about 12 promotion frames, each with a BA run


def cases(device):
    """(kernel, shape, eager call, extra numbers) at the paths' shapes."""
    from perception_tpu_torch.ops.kernels import ransac_score as k1
    from perception_tpu_torch.ops.kernels.build import sm_count
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query

    sms, clock = sm_count(device.index), chip_smoke.max_sm_clock_hz()
    out = []
    for b, n in chip_smoke.K1_TIMED:
        pts, mask, hyp = chip_smoke.kernel_inputs(b, n, 1024, False, device, seed=1)
        bound_ms, _ = chip_smoke.bound(9 * b * n * 1024, chip_smoke.nbytes(pts, mask, hyp) + 4 * b * 1024)
        extra = {"bound_us": bound_ms * 1e3, "floor_us": chip_smoke.k1_floor_ms(b, n, 1024, sms, clock) * 1e3}
        if hasattr(k1, "launch_plan"):
            extra["plan"] = k1.launch_plan(b, n, 1024, sms)._asdict()
        out.append(("K1", f"B={b} {n}x1024", lambda a=(pts, mask, hyp): k1.ransac_score(*a, chip_smoke.TAU), extra))
    for r, n, m in ((1, 4096, 8192), (1, 2048, 4096), (1, 8192, 32768)):
        args = chip_smoke.k2_inputs(r, n, m, False, device, seed=1)
        out.append(("K2", f"{n}x{m}", lambda a=args: gn_system_packed(*a, 0.25, 0.02, return_stats=True), {}))
    for m, nq in ((32768, 2048), (65536, 4096)):
        args, _ = chip_smoke.k3_case(m, nq, "sorted", False, device, seed=1)
        out.append(("K3+K4", f"{nq}q {m}pts", lambda a=args: voxelhash_query(*a), {}))
    return out


def ptxas_reports():
    """{kernel source: ptxas's lines of registers and spills} of this process's builds."""
    from perception_tpu_torch.ops.kernels import build

    out = {}
    for name in chip_smoke.KERNELS:
        log = build.library_path(name).with_name(build.library_path(name).name + ".log")
        out[name] = [line.strip() for line in log.read_text().splitlines()
                     if "registers" in line or "spill" in line] if log.exists() else "not built"
    return out


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 1
    if len(sys.argv) == 2:
        sys.path.insert(0, sys.argv[1])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "package": __import__("perception_tpu_torch").__file__}))
    for kernel, shape, fn, extra in cases(device):
        ms = chip_smoke.cuda_ms(fn, 100)  # before the profiler, which slows the host after it
        per = chip_smoke.profile_launches(fn)
        ours = sum(us for name, us in per.items() if name.startswith(OWN_KERNELS))
        print(json.dumps({"kernel": kernel, "shape": shape, "ms": ms, "kernels_us": ours,
                          "by_kernel_us": per, **extra}))
    print(json.dumps({"ptxas": ptxas_reports()}))

    camera, _, grays, depths = chip_smoke.slam_scene(BA_FRAMES)
    cfg = chip_smoke.slam_configs()["slam keyframe+BA K2"]
    stages = chip_smoke.slam_stage_times(camera, torch.from_numpy(depths).to(device),
                                         torch.from_numpy(grays).to(device), cfg)
    print(json.dumps({"slam keyframe+BA K2 stage ms": stages, "frames": BA_FRAMES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
