"""Distributed pose-graph optimisation: edge-sharded Gauss-Newton and
asynchronous block-Jacobi relaxation.

Counterpart of ``perception_tpu/parallel/pg_dist.py``; both schemes build
on ``models/slam/backend.pose_graph_system`` (per-edge residuals and
Jacobian blocks, pure sums over edges).

1. ``make_distributed_pose_graph_step``: exact synchronous GN,
   ``backend.optimize_pose_graph`` with its ``reduce`` hook set to an
   ``all_reduce`` over the whole mesh. The edges are split over every
   rank; each assembles its edges' share of the (6N, 6N) normal matrix
   and the gradient, one ``all_reduce`` sums them, and the gauged damped
   solve runs on every rank alike. The accept test compares all-reduced
   costs.
2. ``make_async_pose_graph_relaxer``: block-Jacobi. Nodes are split over
   the ranks (rank d owns nodes [d*own, (d+1)*own)); every rank holds all
   edges and relaxes only its own nodes, each from its 6x6 diagonal block,
   against neighbour poses that are refreshed every ``exchange`` sweeps:
   one ``all_reduce`` (SUM) of the pose table with the nodes a rank does
   not own zeroed. The other ranks add exact zeros, so the refreshed
   table holds each owner's bits. Between refreshes a rank relaxes
   against stale neighbours: the asynchronous trade.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.slam.backend import PoseGraph, _onehot, optimize_pose_graph, pose_graph_system
from perception_tpu_torch.parallel.mesh import all_reduce, axis_index, group


def make_distributed_pose_graph_step(
    mesh: Optional[DeviceMesh],
    N: int,
    iterations: int = 10,
    damping: float = 1e-4,
):
    """Edge-sharded GN over ``mesh``: ``step(graph) -> (poses, c0, c1)``,
    ``graph`` holding the replicated poses (N, 4, 4) and this rank's block
    of the edges (axis 0 split over every mesh rank; padding edges carry
    ``edge_mask=False``). The poses are orthonormalised at the end.
    ``mesh=None`` runs one rank holding every edge. (The cost divides by
    the count of masked-in edges, ``optimize_pose_graph``'s; the JAX step
    counts edges of positive weight: the same for positive weights.)"""
    grp = group(mesh, None if mesh is None else tuple(mesh.mesh_dim_names))

    def step(graph: PoseGraph) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if graph.poses_wc.shape[0] != N:
            raise ValueError(f"graph of {graph.poses_wc.shape[0]} nodes; the step was built for {N}")
        return optimize_pose_graph(graph, iterations=iterations, damping=damping,
                                   reduce=lambda tensors: all_reduce(tensors, grp))

    return step


def make_async_pose_graph_relaxer(
    mesh: Optional[DeviceMesh],
    N: int,
    sweeps: int = 24,
    exchange: int = 4,
    damping: float = 1e-3,
):
    """Block-Jacobi relaxation over every rank of ``mesh``:
    ``relax(graph) -> (poses, c0, c1)`` with the whole graph on every rank.
    Each sweep moves the rank's own nodes by 0.7 of their block step (node
    0 stays: the gauge); ``max(sweeps // exchange, 1)`` rounds of
    ``exchange`` sweeps each end in a refresh, and one more refresh ends
    the run. ``mesh=None`` runs one rank owning every node."""
    axes = None if mesh is None else tuple(mesh.mesh_dim_names)
    grp = group(mesh, axes)
    d, D = axis_index(mesh, axes)
    own = (N + D - 1) // D

    def relax(graph: PoseGraph) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        w = (graph.edge_weight * graph.edge_mask).to(torch.float32)
        ei, ej, Tm_inv, dev = graph.edge_i.long(), graph.edge_j.long(), se3.inverse(graph.edge_T), w.device
        sw = torch.sqrt(torch.clamp(w, min=0.0))
        n_edges = torch.clamp(torch.sum(w > 0), min=1)
        node = torch.arange(N, device=dev)
        owned = (node >= d * own) & (node < (d + 1) * own)
        upd = (owned & (node != 0))[:, None]
        oh = _onehot(torch.cat([ei, ej]), N).T  # (N, 2E)
        eye = damping * torch.eye(6, device=dev)
        zero = torch.zeros((), device=dev)

        def cost(poses):
            r = se3.se3_log(Tm_inv @ se3.inverse(poses[ei]) @ poses[ej]) * sw[:, None]
            return torch.sum(r * r) / n_edges

        def refresh(poses):
            return se3.orthonormalize_T(all_reduce([torch.where(owned[:, None, None], poses, zero)], grp)[0])

        poses = graph.poses_wc
        c0 = cost(poses)
        for _ in range(max(sweeps // exchange, 1)):
            for _ in range(exchange):
                r, Ji, Jj = pose_graph_system(poses, ei, ej, Tm_inv, w)
                Hd = (oh @ torch.cat([Ji.transpose(1, 2) @ Ji, Jj.transpose(1, 2) @ Jj]).reshape(-1, 36))
                g = oh @ torch.cat([-torch.einsum("eai,ea->ei", Ji, r), -torch.einsum("eai,ea->ei", Jj, r)])
                delta = torch.linalg.solve_ex(Hd.reshape(N, 6, 6) + eye, g[..., None])[0][..., 0]
                poses = poses @ se3.se3_exp(torch.where(upd, 0.7 * delta, zero))
            poses = refresh(poses)
        poses = refresh(poses)
        return poses, c0, cost(poses)

    return relax
