"""Euclidean clustering as connected components, on torch tensors.

Counterpart of ``perception_tpu/ops/cluster.py``: points are quantised to
voxels of side ``tolerance``; components over occupied voxels (or, with
``refine=True``, over points joined by distance-checked edges to the
first ``window`` points of each of the 27 neighbour cells) come from
min-label propagation with pointer doubling; components are size-gated
and ranked into dense slots, biggest first.

The JAX package's ``lax.while_loop`` stops when no label changes. A
converged labelling is a fixed point of one propagation round, so the
port runs ``max_iters`` rounds, which gives the same labels and never
reads a value back to the host. Scatters whose losers share one slot in
the JAX package write them to a dump slot past the end here (CUDA's
``index_put_`` picks no defined winner among duplicate indices).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.features import _top_k
from perception_tpu_torch.ops.points import apply_mask


class Clusters(NamedTuple):
    labels: torch.Tensor        # (N,) int32 cluster id in [0, max_clusters) or -1
    sizes: torch.Tensor         # (max_clusters,) int32 point count (0 = unused slot)
    num_clusters: torch.Tensor  # () int32 clusters passing the size gate
    centroids: torch.Tensor     # (max_clusters, 3) cluster centroids


def _min_label_rounds(labels, gather_neighbours, alive, n: int, rounds: int):
    """``rounds`` rounds of neighbour min-label propagation, each followed
    by 5 pointer-doubling hops (labels[j] <= j, so hops only shrink).
    ``labels`` is (n + 1,) with the sentinel label n at index n;
    ``gather_neighbours(labels)`` gives each row's (n, C) neighbour labels."""
    sentinel = torch.full((1,), n, dtype=labels.dtype, device=labels.device)
    for _ in range(rounds):
        new = torch.minimum(labels[:n], gather_neighbours(labels).amin(dim=1))
        new = torch.where(alive, new, sentinel)
        for _ in range(5):
            new = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
        new = torch.where(alive, new, sentinel)
        labels = torch.cat([new, sentinel])
    return labels[:n]


def euclidean_cluster(
    points: torch.Tensor,
    mask: torch.Tensor,
    tolerance: float = 0.02,
    min_size: int = 200,
    max_size: int = 25000,
    max_clusters: int = 32,
    max_iters: int = 64,
    origin=(-5.0, -5.0, -5.0),
    dims=(1024, 1024, 1024),
    refine: bool = False,
    window: int = 16,
) -> Clusters:
    """Cluster a masked (N, 3) cloud: per-point labels and cluster stats.
    Cluster ids are assigned in decreasing size order (slot 0 = biggest);
    ids >= max_clusters collapse to -1."""
    n = points.shape[0]
    dev = points.device
    i32 = dict(dtype=torch.int32, device=dev)
    cell = torch.floor((points - const(origin, points)) / const(tolerance, points)).to(torch.int32)
    c = [torch.clamp(cell[:, a], 0, dims[a] - 1) for a in range(3)]
    ids = (c[0] * dims[1] + c[1]) * dims[2] + c[2]
    big = dims[0] * dims[1] * dims[2]
    ids = torch.where(mask, ids, torch.full_like(ids, big))

    # Unique occupied voxels, sorted; per-point voxel rank.
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    vox_valid_sorted = sorted_ids < big
    first = first & vox_valid_sorted
    rank_sorted = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1

    # vox_ids[v] = cell id of voxel rank v (padded with big); the non-first
    # rows go to the dump slot n.
    vox_ids = torch.full((n + 1,), big, **i32)
    vox_ids[torch.where(first, rank_sorted, n)] = torch.where(first, sorted_ids, torch.full_like(sorted_ids, big))
    vox_ids = vox_ids[:n]
    point_rank = torch.empty(n, **i32)
    point_rank[order] = torch.where(vox_valid_sorted, rank_sorted, torch.full_like(rank_sorted, -1))

    offs = torch.from_numpy(np.array(
        [(dx * dims[1] + dy) * dims[2] + dz for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        np.int32,
    )).to(dev, non_blocking=True)
    vox_alive = vox_ids < big
    # The 27 neighbour cells' voxel ranks, resolved once (n = unoccupied).
    neigh_ids = vox_ids[:, None] + offs[None, :]
    pos = torch.clamp(torch.searchsorted(vox_ids, neigh_ids), 0, n - 1)
    neigh_pos = torch.where(vox_ids[pos] == neigh_ids, pos, torch.full_like(pos, n))

    if refine:
        # Point-level edges: the first `window` points of each neighbour
        # cell (contiguous in the cell-sorted order), kept where the pair
        # lies within the tolerance.
        seg_start = torch.searchsorted(sorted_ids, vox_ids)
        seg_end = torch.searchsorted(sorted_ids, vox_ids, right=True)
        pr = torch.clamp(point_rank, 0, n - 1).long()
        nb = neigh_pos[pr]
        nb_ok = (nb < n) & (point_rank >= 0)[:, None]
        nbc = torch.clamp(nb, 0, n - 1)
        starts, ends = seg_start[nbc], seg_end[nbc]
        cand_pos = starts[..., None] + torch.arange(window, **i32)
        cand_ok = nb_ok[..., None] & (cand_pos < ends[..., None])
        cand_idx = order[torch.clamp(cand_pos, 0, n - 1)]
        d2 = torch.sum((points[:, None, None, :] - points[cand_idx]) ** 2, dim=-1)
        tol = const(tolerance, points)
        cand_ok = cand_ok & (d2 <= tol * tol) & mask[cand_idx]
        cand_idx = cand_idx.reshape(n, -1)
        cand_ok = cand_ok.reshape(n, -1)
        sentinel = torch.full((), n, **i32)

        init = torch.where(mask, torch.arange(n, **i32), sentinel)
        labels = _min_label_rounds(
            torch.cat([init, sentinel[None]]),
            lambda lab: torch.where(cand_ok, lab[cand_idx], sentinel),
            mask, n, max_iters,
        )
        point_root = torch.where(mask, labels, sentinel)
        return _rank_components(points, mask, point_root, n, min_size, max_size, max_clusters)

    sentinel = torch.full((), n, **i32)
    init = torch.where(vox_alive, torch.arange(n, **i32), sentinel)
    labels_vox = _min_label_rounds(
        torch.cat([init, sentinel[None]]), lambda lab: lab[neigh_pos], vox_alive, n, max_iters
    )
    point_root = torch.where(point_rank >= 0, labels_vox[torch.clamp(point_rank, 0, n - 1).long()], sentinel)
    return _rank_components(points, mask, point_root, n, min_size, max_size, max_clusters)


def _rank_components(points, mask, point_root, n, min_size, max_size, max_clusters) -> Clusters:
    """Size-gate the components, rank them by size into dense slots and
    compute their stats. ``point_root`` maps each point to a root id in
    [0, n) (n = invalid)."""
    dev = points.device
    root = torch.clamp(point_root, 0, n).long()
    # Component sizes in points (integer adds: exact in any order).
    comp_sizes = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(0, root, mask.to(torch.int32))[:n]
    comp_ok = (comp_sizes >= min_size) & (comp_sizes <= max_size)
    comp_score = torch.where(comp_ok, comp_sizes, torch.full_like(comp_sizes, -1))
    kk = min(max_clusters, n)
    top_vals, top_idx = _top_k(comp_score, kk)  # ties to the lower root, as lax.top_k
    if kk < max_clusters:
        top_vals = torch.cat([top_vals, torch.full((max_clusters - kk,), -1, dtype=top_vals.dtype, device=dev)])
        top_idx = torch.cat([top_idx, torch.zeros(max_clusters - kk, dtype=top_idx.dtype, device=dev)])
    slot_valid = top_vals > 0
    # dense_of_root[root] = slot or -1; invalid slots go to the dump slot n + 1.
    dense_of_root = torch.full((n + 2,), -1, dtype=torch.int32, device=dev)
    dense_of_root[torch.where(slot_valid, top_idx, torch.full_like(top_idx, n + 1))] = torch.where(
        slot_valid, torch.arange(max_clusters, dtype=torch.int32, device=dev), torch.full_like(top_vals, -1))
    labels = torch.where(mask, dense_of_root[root], torch.full_like(point_root, -1))

    sizes = torch.where(slot_valid, top_vals, torch.zeros_like(top_vals))
    num = torch.sum(slot_valid, dtype=torch.int32)

    # Centroids per dense slot. On CUDA index_add_ adds floats with atomics,
    # so a centroid may differ from the CPU's in the last ulps.
    seg = torch.where(labels >= 0, labels, torch.full_like(labels, max_clusters)).long()
    pw = points * (labels >= 0)[:, None]
    sums = torch.zeros((max_clusters + 1, 3), dtype=points.dtype, device=dev).index_add_(0, seg, pw)[:max_clusters]
    centroids = sums / torch.clamp(sizes[:, None].to(points.dtype), min=1.0)
    return Clusters(labels=labels, sizes=sizes, num_clusters=num, centroids=centroids)


def gather_clusters(points, labels, num: int, capacity: int):
    """Every cluster 0..num-1 gathered to its own fixed-capacity row: one
    stable argsort over (num, N). Returns ((num, capacity, 3) points
    parked at the sentinel where masked, (num, capacity) masks)."""
    sel = labels[None, :] == torch.arange(num, dtype=labels.dtype, device=labels.device)[:, None]
    idx = torch.argsort((~sel).to(torch.uint8), dim=1, stable=True)[:, :capacity]
    out_mask = torch.gather(sel, 1, idx)
    return apply_mask(points[idx], out_mask), out_mask


def extract_cluster(points, labels, cluster_id: int, capacity: int):
    """Gather one cluster's points to a fixed-capacity masked cloud."""
    m = labels == cluster_id
    idx = torch.argsort((~m).to(torch.uint8), stable=True)[:capacity]
    out_mask = m[idx]
    return apply_mask(points[idx], out_mask), out_mask
