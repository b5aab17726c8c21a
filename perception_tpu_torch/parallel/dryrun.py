"""The multi-device dry run: every distributed step of ``parallel/`` on a
fleet of ranks, each held to a single-rank run and to ground truth.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip`` and
``tests/multihost_worker.py``. ``--ranks R`` ranks are spawned on this host
(``multihost.run_fleet``) in a process group of ``--backend`` on
``--device``, with the mesh (dp, sp) = (R/2, 2) for even R, else (R, 1).
At the dry run's headline shapes (``--small``: the tests' shapes):

- **ICP**: B = dp frames of 2048·sp points against a replicated
  32768-point three-plane map, 4 GN iterations;
- **BA**: 5 poses, 1024 landmarks, 4096 observations sharded over every
  rank (``SlamConfig``'s window), each landmark seen from 4 of the poses
  with its depth, 3 LM iterations;
- **pose graph**, both schemes: 64 nodes, 192 edges (the SLAM bench's
  ``max_keyframes``), 6 GN iterations; the relaxer 16 sweeps, exchange 4;
- **data-parallel training**: example 06's MPI_15 ``PoseNet``
  (``init_posenet``) at 368x368, B = 8 split over the ranks, one momentum
  step at 1e-3 (``--small``: the JAX dry run's tiny net at 32x32, B = 2R);
- **map-sharded odometry**: a 32768-point map in row blocks over the
  ranks, 4096-point frames tracked over a 4-frame trajectory, 6
  iterations a frame.

The maps of ICP and odometry are three planes, and their normals are
the planes' axes (the JAX dry run estimates them by ``normals_knn``, which
is no part of this layer). The BA window is the JAX dry run's made
well-posed: there, 4096 observations of 1024 landmarks from 5 poses
leave 205 landmarks unseen, and without depth the scale is free, so
float32 summation order alone moves where 3 iterations stop. Here every
landmark is seen 4 times, from 4 poses, with its depth weighted as the
SLAM system weighs it (``ba_depth_weight`` 1: fx / z pixels a metre).

Each rank also runs every step alone (``mesh=None``: all the data, no
collective) on its device and holds the sharded result to it and to the
truth: ICP off the true poses < 5e-2 (the JAX dry run's bound) and off
the single rank < 1e-4; BA off the single rank < 1e-4, its final cost
below the initial one and within the JAX dry run's bound of the single
rank's (relative 0.5, or below 1e-2); the pose graph < 5e-4; the map
trajectory < 1e-3 against single and < 5e-3 against the truth; the
relaxer lowers the cost; the training step's loss within 1e-5 relative
and each gradient within 2e-3 of its tensor's largest. Replicated
outputs must be bit-identical on every rank
(``multihost.fetch_replicated``). ``run`` prints one OK line per step
(the errors, the ms of a call: host clock, the median of ``reps`` calls
after the checked one, synchronized, NaN for none; and the step's
seconds on rank 0, the single-rank run and the checks included) and
returns rank 0's results, for a caller that compares fleets
(``chip_smoke.py``); a failing rank makes it raise.

From the repository root:
``python -m perception_tpu_torch.parallel.dryrun --ranks R --backend {gloo,nccl} --device {cpu,cuda} [--small]``.
NCCL takes one rank a card; ranks that share a card use gloo.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.slam.backend import BAProblem, PoseGraph
from perception_tpu_torch.parallel.ba_dist import make_distributed_ba_step
from perception_tpu_torch.parallel.icp_dist import make_distributed_icp_step
from perception_tpu_torch.parallel.map_dist import make_map_sharded_gn, map_sharding
from perception_tpu_torch.parallel.mesh import Sharding, flat_mesh, frame_sharding, make_mesh
from perception_tpu_torch.parallel.multihost import fetch_replicated, run_fleet
from perception_tpu_torch.parallel.pg_dist import make_async_pose_graph_relaxer, make_distributed_pose_graph_step
from perception_tpu_torch.parallel.scaling import make_problem, three_planes

HEADLINE = dict(icp_points=2048, icp_map=32768, ba_landmarks=1024, ba_obs=4096, pg_nodes=64, pg_edges=192,
                map_points=32768, map_src=4096, train="MPI_15", train_hw=(368, 368), train_batch=8)
SMALL = dict(icp_points=256, icp_map=2048, ba_landmarks=64, ba_obs=256, pg_nodes=16, pg_edges=48,
             map_points=4096, map_src=1024, train="tiny", train_hw=(32, 32), train_batch=None)
POSE_TOL = 1e-4   # ICP transforms and BA poses, sharded against single
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 2e-3
FLEET_TIMEOUT_S = 300.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps):
    """(first result, median ms of ``reps`` more calls, NaN for none): host
    clock around each synchronized call, the ranks lined up by a barrier
    first."""
    out = fn()
    _sync(device)
    ms = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ms) if ms else float("nan")


def _require(ok, message):
    if not ok:
        raise AssertionError(message)


def _max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a.float().cpu() - b.float().cpu())))


def _fmt(err) -> str:
    return "not run" if err is None else f"{err:.3e}"


def icp(mesh, dp, sp, shape, device, reps, single):
    B, N = dp, shape["icp_points"] * sp
    (frames, masks, init, tgt, tn, tm), Ts = make_problem(B, N, shape["icp_map"], seed=0, device=device)
    fs, rows = frame_sharding(mesh), Sharding(mesh, ("dp",))
    step = make_distributed_icp_step(mesh, iterations=4)
    args = (fs.shard(frames), fs.shard(masks), rows.shard(init), tgt, tn, tm)
    res, ms = _timed(lambda: step(*args), device, reps)
    gt_err = _max_abs(res.transforms, rows.shard(Ts))
    _require(gt_err < 5e-2, f"icp: off the true poses by {gt_err}")
    _require(bool(torch.isfinite(res.mean_residual)), "icp: mean residual not finite")
    single_err = None
    if single:
        ref = make_distributed_icp_step(None, iterations=4)(frames, masks, init, tgt, tn, tm)
        single_err = _max_abs(res.transforms, rows.shard(ref.transforms))
        _require(single_err < POSE_TOL, f"icp: sharded != single by {single_err}")
    fetch_replicated(res.transforms, mesh.get_group("sp"))
    out = {"transforms": fetch_replicated(_gather_rows(res.transforms, mesh)),
           "mean_residual": fetch_replicated(res.mean_residual), "num_corr": fetch_replicated(res.num_corr)}
    line = (f"mesh=({dp}x{sp}) B={B} N={N} M={shape['icp_map']}: gt_err={gt_err:.3e} single_err={_fmt(single_err)} "
            f"mean_residual={float(res.mean_residual):.5f} corr={int(res.num_corr)}")
    return out, line, ms


def _gather_rows(x, mesh):
    """The (B/dp, ...) blocks of every dp row, in order, on every rank."""
    grp = mesh.get_group("dp")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, x.contiguous(), group=grp)
    return torch.cat(parts)


def ba_problem(shape, device):
    """The dry run's BA window (numpy seeds; module docstring): 5 poses
    0.2 m apart, landmarks 2-4 m in front, landmark l seen by observations
    l, l + L, ... from poses l, l + 1, ... (mod 5), each with its depth and
    the depth weight fx / z, landmarks started 1 cm off."""
    Mp, L, O = 5, shape["ba_landmarks"], shape["ba_obs"]
    rng = np.random.default_rng(3)
    lms = np.stack([rng.uniform(-1, 1, L), rng.uniform(-0.8, 0.8, L), rng.uniform(2.0, 4.0, L)], 1).astype(np.float32)
    tw = np.zeros((Mp, 6), np.float32)
    tw[:, 0] = np.arange(Mp) * 0.2
    poses = se3.se3_exp(torch.from_numpy(tw))
    obs_lm = torch.arange(O) % L
    obs_pose = (torch.arange(O) // L + obs_lm) % Mp
    T_cw = se3.inverse(poses)
    X = torch.from_numpy(lms)
    pc = (T_cw[obs_pose, :3, :3] @ X[obs_lm][:, :, None])[:, :, 0] + T_cw[obs_pose, :3, 3]
    fx = fy = 525.0
    cx, cy = 319.5, 239.5
    uv = torch.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
    prob = BAProblem(poses_wc=poses, landmarks=X + 0.01, obs_pose=obs_pose.to(torch.int32),
                     obs_lm=obs_lm.to(torch.int32), obs_uv=uv, obs_mask=torch.ones(O, dtype=torch.bool),
                     obs_z=pc[:, 2], obs_zw=fx / pc[:, 2])
    return BAProblem(*(x.to(device) for x in prob)), (fx, fy, cx, cy), Mp, L


def ba(mesh, dp, sp, shape, device, reps, single):
    prob, K, Mp, L = ba_problem(shape, device)
    obs = Sharding(mesh, (("dp", "sp"),))
    local = prob._replace(**{f: obs.shard(getattr(prob, f)) for f in BAProblem._fields[2:]})
    step = make_distributed_ba_step(mesh, Mp, L, iterations=3)
    res, ms = _timed(lambda: step(local, *K), device, reps)
    c0, c1 = float(res.initial_cost), float(res.final_cost)
    _require(c1 < c0, f"ba: cost {c0} -> {c1} did not fall")
    err = r1 = None
    if single:
        ref = make_distributed_ba_step(None, Mp, L, iterations=3)(prob, *K)
        err, r1 = _max_abs(res.poses_wc, ref.poses_wc), float(ref.final_cost)
        _require(err < POSE_TOL, f"ba: sharded != single by {err}")
        # The JAX dry run's bound on the final costs.
        _require(abs(c1 - r1) / max(r1, 1e-9) < 0.5 or c1 < 1e-2, f"ba: final cost {c1} against single {r1}")
    out = {name: fetch_replicated(getattr(res, name)) for name in res._fields}
    line = (f"O={prob.obs_uv.shape[0]} over {dp * sp} ranks, L={L}: cost {c0:.4f} -> {c1:.3e} "
            f"(single {_fmt(r1)}), single_err={_fmt(err)}")
    return out, line, ms


def pose_graph(shape, device):
    """The dry run's chain with skip edges, perturbed 0.03 (numpy seed)."""
    N, E = shape["pg_nodes"], shape["pg_edges"]
    tw = np.zeros((N, 6), np.float32)
    tw[:, 0] = np.arange(N) * 0.1
    tw[:, 4] = np.arange(N) * 0.05
    true = se3.se3_exp(torch.from_numpy(tw))
    ei = torch.arange(E) % (N - 1)
    ej = torch.minimum(ei + 1 + (torch.arange(E) // (N - 1)) % 2, torch.tensor(N - 1))
    pert = np.random.default_rng(8).standard_normal((N, 6)).astype(np.float32) * 0.03
    pert[0] = 0.0
    g = PoseGraph(poses_wc=true @ se3.se3_exp(torch.from_numpy(pert)), edge_i=ei.to(torch.int32),
                  edge_j=ej.to(torch.int32), edge_T=se3.inverse(true[ei]) @ true[ej],
                  edge_weight=torch.ones(E), edge_mask=ei != ej)
    return PoseGraph(*(x.to(device) for x in g))


def pg(mesh, dp, sp, shape, device, reps, single):
    graph = pose_graph(shape, device)
    N = graph.poses_wc.shape[0]
    edges = Sharding(mesh, (("dp", "sp"),))
    local = graph._replace(**{f: edges.shard(getattr(graph, f)) for f in PoseGraph._fields[1:]})
    step = make_distributed_pose_graph_step(mesh, N=N, iterations=6)
    (poses, c0, c1), ms = _timed(lambda: step(local), device, reps)
    _require(float(c1) < float(c0), f"pose graph: cost {float(c0)} -> {float(c1)} did not fall")
    err = None
    if single:
        err = _max_abs(poses, make_distributed_pose_graph_step(None, N=N, iterations=6)(graph)[0])
        _require(err < 5e-4, f"pose graph: sharded != single by {err}")
    out = {"poses": fetch_replicated(poses), "c0": fetch_replicated(c0), "c1": fetch_replicated(c1)}
    line = (f"E={graph.edge_i.shape[0]} over {dp * sp} ranks, N={N}: cost {float(c0):.5f} -> {float(c1):.3e}, "
            f"single_err={_fmt(err)}")
    return out, line, ms


def relax(mesh, dp, sp, shape, device, reps, single):
    graph = pose_graph(shape, device)
    N = graph.poses_wc.shape[0]
    relaxer = make_async_pose_graph_relaxer(mesh, N=N, sweeps=16, exchange=4)
    (poses, c0, c1), ms = _timed(lambda: relaxer(graph), device, reps)
    _require(float(c1) < float(c0), f"relaxer: cost {float(c0)} -> {float(c1)} did not fall")
    out = {"poses": fetch_replicated(poses), "c0": fetch_replicated(c0), "c1": fetch_replicated(c1)}
    line = f"N={N} nodes over {dp * sp} ranks, 16 sweeps: cost {float(c0):.5f} -> {float(c1):.6f}"
    return out, line, ms


def train_net(shape, device):
    from perception_tpu_torch.models.pose import PoseNet, flax_init_, init_posenet

    gen = torch.Generator().manual_seed(6)
    if shape["train"] == "tiny":  # the JAX dry run's net
        net = flax_init_(PoseNet(num_parts=15, num_limbs=14, num_stages=1, backbone_widths=(4, 4, 4),
                                 stage_width=8, stage_depth=1), gen).to(device)
    else:
        net = init_posenet(gen, shape["train"], device)
    return net


def train(mesh, dp, sp, shape, device, reps, single):
    from perception_tpu_torch.models.pose_data import make_batch
    from perception_tpu_torch.models.train import init_train_state, make_optimizer, make_train_step

    R = dist.get_world_size()
    B = shape["train_batch"] or 2 * R
    batch = make_batch(np.random.default_rng(7), B, shape["train_hw"], device=device)
    batch = {k: v for k, v in batch.items() if k != "scene"}
    flat = flat_mesh("dp")  # the JAX dry run's flat "dp" mesh over every rank
    mine = {k: Sharding(flat, ("dp",)).shard(v) for k, v in batch.items()}
    optimizer = make_optimizer(1e-3, "momentum")
    state = init_train_state(train_net(shape, device), optimizer)
    step = make_train_step(optimizer, axis_name=flat.get_group("dp"))
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    state, loss = step(state, mine)
    _sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    _require(bool(torch.isfinite(loss)), f"train: loss {float(loss)}")
    grads = {n: p.grad.clone() for n, p in state.params.named_parameters()}
    params = torch.cat([p.detach().reshape(-1) for p in state.params.parameters()])
    out = {"loss": fetch_replicated(loss), "params": fetch_replicated(params),
           "grads": {n: g.cpu().numpy() for n, g in grads.items()}}
    against = ""
    if single:
        ref_state = init_train_state(train_net(shape, device), optimizer)
        _, ref_loss = make_train_step(optimizer)(ref_state, batch)
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        grad_err = max(_max_abs(grads[n], p.grad) / max(float(p.grad.abs().max()), 1e-30)
                       for n, p in ref_state.params.named_parameters())
        _require(loss_rel <= TRAIN_LOSS_RTOL, f"train: loss {float(loss)} against single {float(ref_loss)}")
        _require(grad_err <= TRAIN_GRAD_TOL, f"train: a gradient off by {grad_err} of its largest")
        against = (f" (single {float(ref_loss):.6f}, rel {loss_rel:.2e}), gradients within {grad_err:.2e} "
                   f"of their largest")
    ms = _timed(lambda: step(state, mine), device, reps)[1] if reps else float("nan")
    n_params = sum(p.numel() for p in state.params.parameters())
    line = (f"{shape['train']} PoseNet ({n_params} parameters) {shape['train_hw'][0]}x{shape['train_hw'][1]}, "
            f"B={B} over {R} ranks: loss {float(loss):.6f}{against}; first step {first_ms:.2f} ms")
    return out, line, ms


def map_odometry(mesh, dp, sp, shape, device, reps, single):
    M, Nsrc = shape["map_points"], shape["map_src"]
    rng = np.random.default_rng(9)
    pts, nrm = (torch.from_numpy(a).to(device) for a in three_planes(rng, M, -1.0, 1.0))
    mask = torch.ones(M, dtype=torch.bool, device=device)
    flat = flat_mesh("mp")
    rows = map_sharding(flat)
    local = (rows.shard(pts), rows.shard(nrm), rows.shard(mask))
    step = make_map_sharded_gn(flat, iterations=6)
    one_rank = make_map_sharded_gn(None, iterations=6)
    T_s = T_r = torch.eye(4, device=device)
    traj_err = 0.0 if single else None
    gt_err = fit = 0.0
    times, transforms = [], []
    for f in range(4):
        T_gt = se3.se3_exp(torch.tensor([0.03 * (f + 1), 0.015 * f, -0.01 * f, 0.0, 0.01 * f, 0.005 * f]))
        sel = torch.from_numpy(rng.integers(0, M, Nsrc)).to(device)
        src = se3.transform_points(se3.inverse(T_gt.to(device)), pts[sel])
        smask = torch.ones(Nsrc, dtype=torch.bool, device=device)
        T_prev = T_s
        res, ms = _timed(lambda: step(*local, src, smask, T_prev), device, min(reps, 1))
        times.append(ms)
        if single:
            T_r = one_rank(pts, nrm, mask, src, smask, T_r).transform
            traj_err = max(traj_err, _max_abs(res.transform, T_r))
        gt_err = max(gt_err, _max_abs(res.transform, T_gt))
        fit += float(res.fitness) / 4
        T_s = res.transform
        transforms.append(fetch_replicated(res.transform))
        fetch_replicated(res.fitness)
        fetch_replicated(res.num_corr)
    _require(gt_err < 5e-3, f"map odometry: off the truth by {gt_err}")
    _require(traj_err is None or traj_err < 1e-3, f"map odometry: sharded != single trajectory by {traj_err}")
    out = {"transforms": np.stack(transforms)}
    line = (f"map {M} in row blocks over {dist.get_world_size()} ranks, {Nsrc}-point frames x4: "
            f"traj_err={_fmt(traj_err)} gt_err={gt_err:.3e} fitness={fit:.3e}")
    return out, line, statistics.median(times)


STEPS = (("icp", icp), ("ba", ba), ("pose_graph", pg), ("relaxer", relax), ("train", train),
         ("map_odometry", map_odometry))


def dryrun_rank(rank, device, small: bool, reps: int, single: bool) -> dict:
    """Every step on this rank; returns {step: (outputs, line, ms a call,
    seconds of the step)}."""
    R = dist.get_world_size()
    sp = 2 if R % 2 == 0 else 1
    dp = R // sp
    mesh = make_mesh(dp, sp)
    shape = SMALL if small else HEADLINE
    out = {}
    for name, fn in STEPS:
        t0 = time.perf_counter()
        out[name] = (*fn(mesh, dp, sp, shape, device, reps, single), time.perf_counter() - t0)
    return out


def run(ranks: int, backend: str, device: str, small: bool = False, reps: int = 3, threads: int = 1,
        single: bool = True) -> dict:
    """The dry run on a fleet of ``ranks`` (``threads`` torch threads a
    rank; ``reps`` timed calls of each step after its checked one;
    ``single``: each rank also runs every step alone and is held to it).
    Prints one OK line a step and returns rank 0's {step: (outputs, line,
    ms a call, seconds)}; raises if a rank fails."""
    t0 = time.perf_counter()
    results = run_fleet(dryrun_rank, ranks, (small, reps, single), backend=backend, device=device,
                        timeout_s=FLEET_TIMEOUT_S, threads=threads)
    for name, _ in STEPS:
        _, line, ms, seconds = results[0][name]
        worst = max(r[name][2] for r in results)
        print(f"dryrun {name} ok: R={ranks} {backend}/{device}: {line}; {ms:.3f} ms a call "
              f"(rank 0; slowest rank {worst:.3f}); step {seconds:.1f} s; "
              f"replicated outputs bit-identical on {ranks} ranks")
    print(f"dryrun: {ranks} ranks, {time.perf_counter() - t0:.1f} s")
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--small", action="store_true", help="the tests' shapes")
    args = ap.parse_args(argv)
    try:
        run(args.ranks, args.backend, args.device, args.small, threads=max(1, (os.cpu_count() or 1) // args.ranks))
    except (RuntimeError, TimeoutError) as e:
        print(f"dryrun FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
