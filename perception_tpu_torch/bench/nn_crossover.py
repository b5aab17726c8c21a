"""Nearest-neighbour crossover: brute force against the voxel hash.

Counterpart of ``benchmarks/nn_crossover.py``'s ``measure``: the same
clouds (``np.random.RandomState(0)``, a surface-like cloud with a dense
centre), the same radius (0.06) and the same three timings a shape:

  brute_ms      ``nn.nearest_neighbor`` (tiled ``torch.matmul`` distances)
  hash_warm_ms  queries sorted into cell order beforehand
                (``voxelhash.sort_by_cell``), then ``query(sort=False)``: the
                ICP regime, where a frame's source is sorted once
  hash_cold_ms  shuffled queries, the sort inside the timed call

Agreement is index-exact against a float64 ``scipy.spatial.cKDTree``,
counted over the queries whose true neighbour lies within the radius (the
hash's contract). Times are ``bench.timing.bench_ms`` on ``device``.

``cli bench`` reports the rows under ``extra["nn_crossover"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from perception_tpu_torch.bench.timing import bench_ms

DEFAULT_SIZES = [(4096, 8192), (4096, 32768), (4096, 131072),
                 (16384, 131072), (307200, 32768), (307200, 131072)]
RADIUS = 0.06


def _cloud(rng, m):
    """Surface-like cloud (a 2-D manifold in 3-D) with a dense Gaussian centre."""
    ref = rng.randn(m, 3).astype(np.float32)
    ref[:, 2] = 0.2 * np.sin(ref[:, 0] * 3) * np.cos(ref[:, 1] * 3)
    return ref


def clouds(sizes=None):
    """The benchmark's clouds, drawn from one ``RandomState(0)`` in size
    order: (queries, map points, map (m, 3) f32, queries (nq, 3) f32) a
    size, each query a map point moved by 1 cm of Gaussian noise."""
    rng = np.random.RandomState(0)
    for nq, m in sizes or DEFAULT_SIZES:
        ref = _cloud(rng, m)
        q = ref[rng.randint(0, m, nq)] + rng.randn(nq, 3).astype(np.float32) * 0.01
        yield nq, m, ref, q


def measure(sizes=None, iters=10, device="cuda") -> list:
    """One row a (queries, map points) size, with the JAX rows' keys."""
    from scipy.spatial import cKDTree

    from perception_tpu_torch.ops import nn as _nn
    from perception_tpu_torch.ops import voxelhash

    device = torch.device(device)
    rows = []
    for nq, m, ref, q in clouds(sizes):
        reft, qt = torch.from_numpy(ref).to(device), torch.from_numpy(q).to(device)
        mask = torch.ones(m, dtype=torch.bool, device=device)

        t_brute = bench_ms(_nn.nearest_neighbor, qt, reft, mask, iters=iters)

        vh = voxelhash.build(reft, mask, cell_size=RADIUS)

        def cold(v, a):
            return voxelhash.query(v, a, sort=True)

        def warm(v, a):
            return voxelhash.query(v, a, sort=False)

        t_cold = bench_ms(cold, vh, qt, iters=iters)
        q_sorted, order_q = voxelhash.sort_by_cell(vh, qt)
        t_warm = bench_ms(warm, vh, q_sorted, iters=iters)

        # Index-exact agreement against the float64 KD-tree.
        od, oi = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64))
        in_r = od <= RADIUS
        order = vh.order.cpu().numpy()
        hi, _ = cold(vh, qt)
        agree_cold = float(np.mean(order[hi.cpu().numpy()][in_r] == oi[in_r]))
        wi, _ = warm(vh, q_sorted)
        oq = order_q.cpu().numpy()
        agree_warm = float(np.mean((order[wi.cpu().numpy()] == oi[oq])[od[oq] <= RADIUS]))

        rows.append({
            "nq": nq, "m": m,
            "brute_ms": round(t_brute, 3),
            "hash_warm_ms": round(t_warm, 3),
            "hash_cold_ms": round(t_cold, 3),
            "speedup_warm": round(t_brute / t_warm, 2),
            "speedup_cold": round(t_brute / t_cold, 2),
            "agree_pct": round(agree_warm * 100, 1),
            "agree_cold_pct": round(agree_cold * 100, 1),
        })
    return rows
