"""Pose-graph optimisation benchmark at N=256 keyframes, 10 GN iterations.

Counterpart of ``benchmarks/pose_graph_bench.py``'s ``run``: a loop of
``n_nodes`` ground-truth poses with noisy initial poses, an odometry chain
plus every 8th edge turned into a random loop edge (numpy's
``default_rng(0)``, drawn as the JAX benchmark draws them), solved by
``models/slam/backend.optimize_pose_graph`` (per-edge Jacobian blocks
assembled into the (6N, 6N) normal system). It reports

  ms_per_solve              ms a call of ``iterations`` GN steps, the mean
                            of 10 calls after a warm call (host clock,
                            ending in a synchronize on the card)
  initial_cost, final_cost  the solve's costs
  mean_translation_error_m  mean distance of the solved poses from the
                            ground truth

and the node, edge and iteration counts. SLAM promotion frames spend most
of their time in this solve.

Run: ``python -m perception_tpu_torch.bench.pose_graph_bench [N] [E] [--cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from perception_tpu_torch.bench.timing import device_of, sync

REPS = 10


def loop_graph(n_nodes: int, n_edges: int, device):
    """(PoseGraph of the noisy loop, ground-truth poses (N, 4, 4)) on ``device``."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.models.slam.backend import PoseGraph

    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    gt = np.tile(np.eye(4), (n_nodes, 1, 1))
    gt[:, :3, 3] = np.stack([np.cos(t), np.sin(t), 0.1 * np.sin(3 * t)], 1)
    gt = torch.from_numpy(gt.astype(np.float32)).to(device)
    noise = torch.from_numpy((rng.normal(size=(n_nodes, 6)) * 0.03).astype(np.float32)).to(device)
    init = se3.se3_exp(noise) @ gt

    ei = np.arange(n_edges) % (n_nodes - 1)
    ej = ei + 1
    loop = np.arange(0, n_edges, 8)  # every 8th edge becomes a random loop edge
    ej[loop] = (ei[loop] + rng.integers(2, n_nodes - 1, size=len(loop))) % n_nodes
    ei_t, ej_t = (torch.from_numpy(a.astype(np.int32)).to(device) for a in (ei, ej))
    T_meas = se3.inverse(gt[ei_t.long()]) @ gt[ej_t.long()]
    graph = PoseGraph(poses_wc=init, edge_i=ei_t, edge_j=ej_t, edge_T=T_meas,
                      edge_weight=torch.ones(n_edges, device=device), edge_mask=ei_t != ej_t)
    return graph, gt


def run(n_nodes: int = 256, n_edges: int = 768, iterations: int = 10, device="cuda") -> dict:
    from perception_tpu_torch.models.slam.backend import optimize_pose_graph

    device = device_of(device)
    graph, gt = loop_graph(n_nodes, n_edges, device)
    opt, c0, c1 = optimize_pose_graph(graph, iterations=iterations)
    sync(opt)
    t0 = time.perf_counter()
    for _ in range(REPS):
        opt, c0, c1 = optimize_pose_graph(graph, iterations=iterations)
    sync(opt)
    ms = (time.perf_counter() - t0) / REPS * 1000.0

    err = torch.linalg.vector_norm(opt[:, :3, 3] - gt[:, :3, 3], dim=-1)
    return {
        "nodes": n_nodes,
        "edges": n_edges,
        "iterations": iterations,
        "ms_per_solve": round(ms, 2),
        "initial_cost": float(c0),
        "final_cost": float(c1),
        "mean_translation_error_m": float(err.mean()),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_nodes", nargs="?", type=int, default=256)
    p.add_argument("n_edges", nargs="?", type=int, default=768)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    for k, v in run(args.n_nodes, args.n_edges, device="cpu" if args.cpu else "cuda").items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
