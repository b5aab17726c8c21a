"""Rank-side cases of the fleet tests (``tests/test_torch_parallel.py``,
``test_torch_ba_pg_dist.py``, ``test_torch_map_dist.py``,
``test_torch_train_dp.py``): each runs on every rank of a gloo fleet on the
CPU (``parallel/multihost.run_fleet``), takes the global numpy inputs,
keeps its own block, runs the port's distributed step and returns numpy
results to the test. A spawned rank imports this module by name, so it
imports torch and the port only (no JAX).

Every case returns, besides its outputs, whether the outputs replicated
over a group are bit-identical on every rank of it (``fetch_replicated``
raises where they are not).
"""

import copy

import numpy as np
import torch

from perception_tpu_torch.models.slam.backend import BAProblem, PoseGraph
from perception_tpu_torch.parallel import ba_dist, icp_dist, map_dist, pg_dist
from perception_tpu_torch.parallel.mesh import Sharding, flat_mesh, frame_sharding, make_mesh
from perception_tpu_torch.parallel.multihost import fetch_replicated, global_mesh


def T(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


def run_cases(rank, dev, jobs):
    """Several cases in one fleet: ``jobs`` is a list of (case name, its
    argument); returns their results in order."""
    return [globals()[name](rank, dev, arg) for name, arg in jobs]


def mesh_case(rank, dev, _):
    """Mesh shapes, blocks and errors on a fleet of 4."""
    out = {}
    m = make_mesh(dp=2, sp=2)
    out["shape"] = tuple(m.shape)
    out["names"] = tuple(m.mesh_dim_names)
    out["coord"] = tuple(m.get_coordinate())
    out["block"] = frame_sharding(m).block((4, 8, 3))
    out["obs_block"] = Sharding(m, (("dp", "sp"),)).block((12, 2))
    out["global"] = tuple(global_mesh().shape)
    out["sp_only"] = tuple(make_mesh(sp=4).shape)
    try:
        make_mesh(dp=3, sp=2)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


def icp_case(rank, dev, cases):
    """The ICP step on a (dp, sp) fleet for each case dict (frames, masks,
    init, target, normals, tmask, dp, sp, iterations)."""
    out = []
    for c in cases:
        mesh = make_mesh(c["dp"], c["sp"])
        fs = frame_sharding(mesh)
        rows = Sharding(mesh, ("dp",))
        step = icp_dist.make_distributed_icp_step(mesh, iterations=c["iterations"])
        res = step(T(fs.shard(c["frames"]), dev), T(fs.shard(c["masks"]), dev), T(rows.shard(c["init"]), dev),
                   T(c["target"], dev), T(c["normals"], dev), T(c["tmask"], dev))
        out.append({
            "transforms": res.transforms.cpu().numpy(), "block": rows.block(c["init"].shape),
            "sp_equal": fetch_replicated(res.transforms, mesh.get_group("sp")) is not None,
            "mean_residual": fetch_replicated(res.mean_residual), "num_corr": fetch_replicated(res.num_corr),
        })
    return out


def ba_case(rank, dev, cases):
    """Distributed BA on a (dp, sp) fleet for each case dict (the problem's
    arrays, M, L, iterations, K = (fx, fy, cx, cy), dp, sp)."""
    out = []
    for c in cases:
        mesh = make_mesh(c["dp"], c["sp"])
        obs = Sharding(mesh, (("dp", "sp"),))
        prob = BAProblem(poses_wc=T(c["poses_wc"], dev), landmarks=T(c["landmarks"], dev),
                         obs_pose=T(obs.shard(c["obs_pose"]), dev), obs_lm=T(obs.shard(c["obs_lm"]), dev),
                         obs_uv=T(obs.shard(c["obs_uv"]), dev), obs_mask=T(obs.shard(c["obs_mask"]), dev))
        res = ba_dist.make_distributed_ba_step(mesh, c["M"], c["L"], iterations=c["iterations"])(prob, *c["K"])
        out.append({name: fetch_replicated(getattr(res, name)) for name in res._fields})
    return out


def _graph(c, dev, edges=None):
    shard = (lambda a: a) if edges is None else edges.shard
    return PoseGraph(poses_wc=T(c["poses_wc"], dev), edge_i=T(shard(c["edge_i"]), dev),
                     edge_j=T(shard(c["edge_j"]), dev), edge_T=T(shard(c["edge_T"]), dev),
                     edge_weight=T(shard(c["edge_weight"]), dev), edge_mask=T(shard(c["edge_mask"]), dev))


def pg_case(rank, dev, cases):
    """The edge-sharded pose graph ("gn") or the relaxer ("relax") on a
    (dp, sp) fleet for each case dict."""
    out = []
    for c in cases:
        mesh = make_mesh(c["dp"], c["sp"])
        if c["kind"] == "gn":
            step = pg_dist.make_distributed_pose_graph_step(mesh, N=c["N"], iterations=c["iterations"])
            poses, c0, c1 = step(_graph(c, dev, Sharding(mesh, (("dp", "sp"),))))
        else:
            relax = pg_dist.make_async_pose_graph_relaxer(mesh, N=c["N"], sweeps=c["sweeps"], exchange=c["exchange"])
            poses, c0, c1 = relax(_graph(c, dev))
        out.append({"poses": fetch_replicated(poses), "c0": fetch_replicated(c0), "c1": fetch_replicated(c1)})
    return out


def map_case(rank, dev, cases):
    """The map-sharded GN over a flat "mp" fleet: for each case dict a
    trajectory of frames (src (F, N, 3), each started at the last result,
    the first at T0)."""
    mesh = flat_mesh("mp")
    rows = map_dist.map_sharding(mesh)
    out = []
    for c in cases:
        step = map_dist.make_map_sharded_gn(mesh, iterations=c["iterations"])
        T_prev, res_all = T(c["T0"], dev), []
        for src in c["src"]:
            res = step(T(rows.shard(c["map"]), dev), T(rows.shard(c["normals"]), dev),
                       T(rows.shard(c["mask"]), dev), T(src, dev), T(np.ones(len(src), bool), dev), T_prev)
            T_prev = res.transform
            res_all.append([fetch_replicated(x) for x in res])
        out.append({k: np.stack([r[i] for r in res_all]) for i, k in enumerate(("transform", "fitness", "num_corr"))})
    return out


def train_case(rank, dev, case):
    """One data-parallel step over every rank of a flat "dp" fleet, on this
    rank's slice of the batch, from a train state given as the net's and
    the optimizer's state dicts and the count (``convert.
    train_state_from_jax`` of a JAX state, made by the test): the loss, the
    parameters after the update, the averaged gradients."""
    from perception_tpu_torch.models.pose import PoseNet
    from perception_tpu_torch.models.train import init_train_state, make_optimizer, make_train_step

    mesh = flat_mesh("dp")
    optimizer = make_optimizer(case["lr"], case["kind"])
    net = PoseNet(**case["net"])
    net.load_state_dict(case["net_state"])
    state = init_train_state(net.to(dev), optimizer)
    # The state dicts' tensors arrive in memory shared by every rank
    # (torch pickles tensors for a child process that way): a private copy.
    state.opt_state.load_state_dict(copy.deepcopy(case["opt_state"]))
    state = state._replace(step=case["step"])
    rows = Sharding(mesh, ("dp",))
    batch = {k: T(rows.shard(v), dev) for k, v in case["batch"].items()}
    state, loss = make_train_step(optimizer, axis_name=mesh.get_group("dp"))(state, batch)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    return {"loss": fetch_replicated(loss), "flat": fetch_replicated(flat),
            "params": {n: p.detach().cpu().numpy() for n, p in net.named_parameters()},
            "grads": {n: p.grad.cpu().numpy() for n, p in net.named_parameters()}}


def failing_case(rank, dev, _):
    """Rank 1 raises; the fleet must fail its caller."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return rank


def mismatch_case(rank, dev, _):
    """A 'replicated' output that differs between ranks."""
    return fetch_replicated(torch.tensor([float(rank)]))
