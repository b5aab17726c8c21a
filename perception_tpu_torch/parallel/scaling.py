"""Scaling-efficiency harness of the distributed ICP step.

Counterpart of ``perception_tpu/parallel/scaling.py``: frames/s of the
distributed ICP step at growing rank counts, weak scaling
(``frames_per_device`` frames a rank, dp = ranks, sp = 1), and
efficiency = frames/s(n) / (n / n0 * frames/s(n0)). Each count runs as
its own fleet (``multihost.run_fleet``). A fleet of processes sharing one
host's cores, or one card, measures the structure of the sharding, not
the speed of a cluster: the ranks of every count meet over gloo, which
serves CPU ranks and ranks that share a card alike. The problem comes
from numpy seeds (the JAX harness draws it from ``jax.random``), and the
target's normals are its three planes' axes (the JAX harness estimates
them by ``normals_knn``), so the two agree in kind, not bit for bit.

From the repository root: ``python -m perception_tpu_torch.parallel.scaling
[--counts 1 2 4] [--device cuda|cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.parallel.icp_dist import make_distributed_icp_step
from perception_tpu_torch.parallel.mesh import Sharding, frame_sharding, make_mesh
from perception_tpu_torch.parallel.multihost import run_fleet


def three_planes(rng, m: int, lo: float, hi: float):
    """(points (m, 3), normals (m, 3)) float32: points drawn uniformly in
    [lo, hi)^3 and put by thirds on the planes z = 0, y = 0 and x = 0,
    with those planes' unit normals."""
    pts = rng.uniform(lo, hi, (m, 3)).astype(np.float32)
    normals = np.zeros((m, 3), np.float32)
    third = m // 3
    for axis, rows in ((2, slice(0, third)), (1, slice(third, 2 * third)), (0, slice(2 * third, m))):
        pts[rows, axis] = 0.0
        normals[rows, axis] = 1.0
    return pts, normals


def make_problem(B: int, N: int, M: int, seed: int = 0, device="cuda"):
    """(frames (B, N, 3), masks, init poses, target (M, 3), normals, mask)
    on ``device``, and the true poses: a three-plane target and B frames
    sampled from it, moved by small random poses."""
    rng = np.random.default_rng(seed)
    target, target_normals = three_planes(rng, M, -0.3, 0.3)
    tgt = torch.from_numpy(target).to(device)
    tmask = torch.ones(M, dtype=torch.bool, device=device)
    normals = torch.from_numpy(target_normals).to(device)
    Ts = se3.se3_exp(torch.from_numpy((rng.standard_normal((B, 6)) * 0.02).astype(np.float32))).to(device)
    sel = torch.from_numpy(rng.integers(0, M, (B, N))).to(device)
    frames = se3.transform_points(se3.inverse(Ts), tgt[sel])
    init = torch.eye(4, device=device).expand(B, 4, 4).contiguous()
    return (frames, torch.ones((B, N), dtype=torch.bool, device=device), init, tgt, normals, tmask), Ts


def _scaling_rank(rank, device, fpd, points, map_points, iterations, reps) -> dict:
    n = dist.get_world_size()
    mesh = make_mesh(dp=n, sp=1)
    B = fpd * n
    (frames, masks, init, tgt, tn, tm), _ = make_problem(B, points, map_points, device=device)
    fs = frame_sharding(mesh)
    frames, masks, init = fs.shard(frames), fs.shard(masks), Sharding(mesh, ("dp",)).shard(init)
    step = make_distributed_icp_step(mesh, iterations=iterations)

    def run():
        out = step(frames, masks, init, tgt, tn, tm)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    run()  # warm-up
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    dist.barrier()
    dt = time.perf_counter() - t0
    return {"frames_per_sec": B * reps / dt, "batch": B}


def measure_scaling(
    device_counts: List[int],
    frames_per_device: int = 8,
    points: int = 2048,
    map_points: int = 4096,
    iterations: int = 6,
    reps: int = 5,
    device: str = "cuda",
) -> Dict[int, dict]:
    """Throughput at each rank count: {n: {"frames_per_sec", "batch",
    "efficiency"}} (weak scaling: B = frames_per_device * n). (The JAX
    function counts devices of the virtual mesh; here each count is a
    fleet of gloo ranks on ``device``.)"""
    results = {}
    for n in device_counts:
        results[n] = run_fleet(_scaling_rank, n, (frames_per_device, points, map_points, iterations, reps),
                               device=device, timeout_s=300.0)[0]
    n0 = device_counts[0]
    base = results[n0]["frames_per_sec"]
    for n, r in results.items():
        r["efficiency"] = r["frames_per_sec"] / (base * n / n0)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure_scaling(args.counts, device=args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
