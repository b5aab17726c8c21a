"""Example 13 — multi-face tracking facade + the multi-process runtime.

Part A drives the assembled multi-face pipeline through the Perception
facade (the reference's max_faces OpenFace topology,
openface2_ros.cpp:174-183/252-281): three faces rendered into one frame,
detected into tracker slots, then carried through detector-off frames by
the slot tracker: per-face landmarks, head pose, gaze, AU02 gate, all
(max_faces, ...) tensors. The scenes and their noise are the JAX
example's (``key(5)``, drawn by ``utils/jax_random``).

Part B is the multi-process bootstrap (parallel/multihost.py): a fleet of
2 ranks through ``run_fleet`` (gloo; sharing the card, or on the CPU),
each rank running ``rank_main`` below (the JAX example's
``tests/multihost_worker.py``): one global (dp=2, sp=1) mesh, distributed
point-to-plane ICP with the frames split between the processes and
distributed BA with the observations split over the fleet, each held to
a single-rank run of the same step on the rank's own data.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host, load  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.utils import jax_random  # noqa: E402

FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5  # the BA problem's camera


def make_ba_problem(M=4, L=60, noise_px=0.3, pose_noise=0.02, lm_noise=0.02, seed=0):
    """M cameras along x looking +z at L landmarks, with pixel noise and
    perturbed initial poses (pose 0 exact: the gauge) and landmarks: the
    JAX tests' ``make_ba_problem`` in numpy. Returns (arrays, true poses)."""
    from perception_tpu_torch.geometry import se3

    def exp(tw):
        return se3.se3_exp(torch.as_tensor(np.asarray(tw, np.float32))).numpy()

    rng = np.random.RandomState(seed)
    lms = np.stack([rng.uniform(-1, 1, L), rng.uniform(-0.8, 0.8, L), rng.uniform(2.0, 4.0, L)], 1)
    poses = np.stack([exp([0.3 * k, 0.0, 0.0, 0.0, 0.02 * k, 0.0]) for k in range(M)])
    obs_pose, obs_lm, obs_uv = [], [], []
    for k in range(M):
        T_cw = np.linalg.inv(poses[k])
        pc = lms @ T_cw[:3, :3].T + T_cw[:3, 3]
        u = FX * pc[:, 0] / pc[:, 2] + CX
        v = FY * pc[:, 1] / pc[:, 2] + CY
        vis = (pc[:, 2] > 0.1) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        for l in np.where(vis)[0]:
            obs_pose.append(k)
            obs_lm.append(l)
            obs_uv.append([u[l] + rng.randn() * noise_px, v[l] + rng.randn() * noise_px])
    poses_init = poses.copy()
    for k in range(1, M):
        poses_init[k] = poses[k] @ exp(rng.randn(6) * pose_noise)
    lms_init = lms + rng.randn(L, 3) * lm_noise
    problem = {"poses_wc": poses_init.astype(np.float32), "landmarks": lms_init.astype(np.float32),
               "obs_pose": np.asarray(obs_pose, np.int64), "obs_lm": np.asarray(obs_lm, np.int64),
               "obs_uv": np.asarray(obs_uv, np.float32), "obs_mask": np.ones(len(obs_pose), bool)}
    return problem, poses


def rank_main(rank, dev, world):
    """One process of the fleet (the JAX ``tests/multihost_worker.py``):
    sharded ICP and BA, each against this rank's single-rank run on the
    full data; returns the OK lines' numbers."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.models.slam.backend import BAProblem
    from perception_tpu_torch.ops.normals import normals_knn
    from perception_tpu_torch.parallel import multihost
    from perception_tpu_torch.parallel.ba_dist import make_distributed_ba_step
    from perception_tpu_torch.parallel.icp_dist import make_distributed_icp_step

    mesh = multihost.global_mesh()
    assert tuple(mesh.shape) == (world, 1)
    print(f"proc {rank}: joined fleet ({world} processes)", flush=True)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    # ---- distributed point-to-plane ICP, frames split between processes ----
    B, N, M = 2 * world, 1024, 2048
    rng = np.random.default_rng(7)  # identical data in every process
    target = rng.uniform(-0.3, 0.3, (M, 3)).astype(np.float32)
    target[: M // 3, 2] = 0.0
    target[M // 3 : 2 * M // 3, 1] = 0.0
    target[2 * M // 3 :, 0] = 0.0
    tgt_mask = np.ones(M, bool)
    tgt_normals = normals_knn(t(target), t(tgt_mask), k=10)[0]
    twists = (rng.standard_normal((B, 6)) * [0.02, 0.02, 0.02, 0.04, 0.04, 0.04]).astype(np.float32)
    Ts = se3.se3_exp(torch.as_tensor(twists))
    frames = np.stack([se3.transform_points(se3.inverse(Ts[b]), torch.as_tensor(target[rng.integers(0, M, N)])).numpy()
                       for b in range(B)])
    masks = np.ones((B, N), bool)
    init_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()

    ref_T = make_distributed_icp_step(None, iterations=6)(
        t(frames), t(masks), t(init_T), t(target), tgt_normals, t(tgt_mask)).transforms.cpu().numpy()
    rows = slice(rank * (B // world), (rank + 1) * (B // world))
    res = make_distributed_icp_step(mesh, iterations=6)(
        multihost.shard_host_data(mesh, ("dp", "sp"), frames[rows], (B, N, 3), dev),
        multihost.shard_host_data(mesh, ("dp", "sp"), masks[rows], (B, N), dev),
        multihost.shard_host_data(mesh, ("dp",), init_T[rows], (B, 4, 4), dev),
        t(target), tgt_normals, t(tgt_mask))
    T_rank = res.transforms.cpu().numpy()
    err = float(np.max(np.abs(T_rank - ref_T[rows])))
    gt_err = float(np.max(np.abs(T_rank - Ts.numpy()[rows])))
    assert err < 1e-4, f"sharded != single: {err}"
    assert gt_err < 0.01, f"ICP did not recover poses: {gt_err}"
    num_corr = int(multihost.fetch_replicated(res.num_corr))
    print(f"proc {rank}: MULTIHOST ICP OK B={B} N={N} err={err:.2e} gt_err={gt_err:.2e} corr={num_corr}", flush=True)

    # ---- distributed BA, observations split over the whole fleet ----
    Mp, L = 4, 40
    p, _ = make_ba_problem(M=Mp, L=L, seed=5)
    pad = (-len(p["obs_uv"])) % world
    for name in ("obs_pose", "obs_lm", "obs_uv", "obs_mask"):
        p[name] = np.concatenate([p[name], np.zeros((pad,) + p[name].shape[1:], p[name].dtype)])
    O = len(p["obs_uv"])
    ref_ba = make_distributed_ba_step(None, Mp, L, iterations=8)(BAProblem(**{k: t(v) for k, v in p.items()}),
                                                                FX, FY, CX, CY)
    obs = slice(rank * (O // world), (rank + 1) * (O // world))
    shard = {k: (multihost.shard_host_data(mesh, (("dp", "sp"),), v[obs], v.shape, dev) if k.startswith("obs")
                 else multihost.replicate_host_data(mesh, v, dev)) for k, v in p.items()}
    res_ba = make_distributed_ba_step(mesh, Mp, L, iterations=8)(BAProblem(**shard), FX, FY, CX, CY)
    poses = multihost.fetch_replicated(res_ba.poses_wc)
    pose_err = float(np.max(np.abs(poses - ref_ba.poses_wc.cpu().numpy())))
    c0, c1 = float(res_ba.initial_cost), float(res_ba.final_cost)
    # float32 all-reduce summation order through the Schur solve and LM's
    # accept/reject branch: the JAX worker's tolerance.
    assert pose_err < 0.05, f"BA sharded != single: {pose_err}"
    assert c1 < 0.1 * c0, f"BA did not reduce cost: {c0} -> {c1}"
    print(f"proc {rank}: MULTIHOST BA OK O={O} err={pose_err:.2e} cost={c0:.4f}->{c1:.6f}", flush=True)
    multihost.sync("done")
    return {"icp_err": err, "icp_gt_err": gt_err, "num_corr": num_corr, "ba_err": pose_err, "ba_cost": (c0, c1)}


def main(dev=None) -> dict:
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face_data import render_faces, sample_face_at_from_key, stack_scenes
    from perception_tpu_torch.parallel.multihost import run_fleet
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructPose,
    )

    dev = device(dev)
    if not FF.fixture_available():
        print("example 13 skipped (face fixture missing)")
        return {}

    hw = (256, 256)
    key = jax_random.key(5)
    offs = [(-0.14, -0.14), (0.14, -0.14), (0.0, 0.14)]
    stacked = stack_scenes([
        sample_face_at_from_key(jax_random.fold_in(key, i), hw, FF.FIXTURE_FX, FF.FIXTURE_FX, o, 0.62)
        for i, o in enumerate(offs)
    ])

    engine = Perception(
        pose=WrapperStructPose(enabled=False),
        face=WrapperStructFace(enabled=True, max_faces=4, detect_every=3),
        device=dev,
    )
    n_per_frame, reproj = [], []
    for t in range(4):  # frame 0 detects; 1-2 ride the tracker slots
        gray = render_faces(stacked, hw, noise=jax_random.normal(jax_random.fold_in(key, 50 + t), hw))
        img = np.repeat(gray[..., None], 3, axis=-1)
        d = engine.emplace_and_pop(img, frame_index=t)
        mask = host(d.faces["mask"])
        n = int(mask.sum())
        n_per_frame.append(n)
        gates = host(d.faces["pose_gate"])[mask]
        reproj.append([round(float(r), 2) for r in host(d.faces["reproj_px"])[:n]])
        print(f"frame {t}: {n} faces tracked, reproj {reproj[-1]} px, AU02 gate {gates.tolist()}")
    assert n_per_frame == [3, 3, 3, 3], n_per_frame

    # Part B: the 2-process fleet, each rank running rank_main.
    ranks = run_fleet(load(Path(__file__).stem).rank_main, 2, (2,), backend="gloo", device=dev.type,
                      timeout_s=540)
    print("multihost: 2 processes joined one fleet; "
          "distributed ICP+BA sharded across the process boundary == single")
    return {"faces_per_frame": n_per_frame, "reproj_px": reproj, "ranks": ranks}


if __name__ == "__main__":
    main()
