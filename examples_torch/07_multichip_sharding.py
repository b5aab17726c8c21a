"""Example 07 — multi-device sharding on a (dp, sp) mesh of ranks.

The distributed runtime (no reference equivalent: Caffe's NCCL was
single-host data-parallel only): a (dp, sp) mesh over the ranks of a
``torch.distributed`` process group, frames sharded over dp and points
over sp, point-to-plane GN-ICP with the 6x6 normal equations all-reduced
over the mesh. The fleet is ``parallel.multihost.run_fleet``: 4 ranks
(dp=2, sp=2) sharing the card over gloo, or 2 ranks (dp=1, sp=2) on the
CPU; the same code runs one rank a card over NCCL. The shapes keep the
JAX example's rule: B = 2·dp frames of 128·sp points against M = 256, the
data drawn from its keys (``utils/jax_random``).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, load  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.geometry import se3  # noqa: E402
from perception_tpu_torch.ops.normals import normals_knn  # noqa: E402
from perception_tpu_torch.parallel.multihost import fetch_replicated, run_fleet  # noqa: E402
from perception_tpu_torch.utils import jax_random  # noqa: E402


def rank_step(rank, dev, dp, sp, frames, masks, init_T, target, normals, tmask):
    """One rank of the fleet: its block of the frames, the distributed ICP
    step, its transforms (with their block) and the fleet's residual."""
    from perception_tpu_torch.parallel.icp_dist import make_distributed_icp_step
    from perception_tpu_torch.parallel.mesh import Sharding, frame_sharding, make_mesh

    mesh = make_mesh(dp=dp, sp=sp)
    fs, rows = frame_sharding(mesh), Sharding(mesh, ("dp",))

    def t(a):
        return torch.as_tensor(a, device=dev)

    step = make_distributed_icp_step(mesh, iterations=6)
    res = step(t(fs.shard(frames)), t(fs.shard(masks)), t(rows.shard(init_T)), t(target), t(normals), t(tmask))
    return {"rows": rows.block(init_T.shape)[0], "transforms": res.transforms.cpu().numpy(),
            "mean_residual": float(fetch_replicated(res.mean_residual))}


def main(dev=None, ranks=None) -> dict:
    dev = device(dev)
    n = ranks or (4 if dev.type == "cuda" else 2)
    sp = 2 if n % 2 == 0 else 1
    dp = n // sp
    print(f"mesh: {dp} x {sp} over {n} ranks on {dev.type} (gloo)")

    B, N, M = 2 * dp, 128 * sp, 256
    target = jax_random.uniform(jax_random.key(0), (M, 3), -0.3, 0.3)
    target[: M // 2, 2] = 0.0
    target[M // 2:, 1] = 0.0
    tgt_mask = np.ones(M, bool)
    tgt_normals, _ = normals_knn(torch.as_tensor(target, device=dev), torch.as_tensor(tgt_mask, device=dev), k=8)

    # B frames = the target seen under random small motions.
    twists = jax_random.normal(jax_random.key(1), (B, 6)) * np.float32(0.02)
    Ts = se3.se3_exp(torch.as_tensor(twists))
    sel = torch.as_tensor(jax_random.randint(jax_random.key(2), (B, N), 0, M)).long()
    frames = torch.stack([se3.transform_points(se3.inverse(Ts[b]), torch.as_tensor(target)[sel[b]])
                          for b in range(B)]).numpy()

    init_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    outs = run_fleet(load(Path(__file__).stem).rank_step, n,
                     (dp, sp, frames, np.ones((B, N), bool), init_T, target, tgt_normals.cpu().numpy(), tgt_mask),
                     backend="gloo", device=dev.type)
    transforms = np.zeros((B, 4, 4), np.float32)
    for o in outs:
        transforms[o["rows"]] = o["transforms"]

    err = float(np.max(np.abs(transforms - Ts.numpy())))
    residual = outs[0]["mean_residual"]
    print(f"{B} frames x {N} points: mean residual "
          f"{residual:.2e}, max pose error {err:.2e}")
    assert err < 5e-3
    return {"ranks": n, "dp": dp, "sp": sp, "mean_residual": residual, "max_pose_error": err,
            "transforms": transforms}


if __name__ == "__main__":
    main()
