"""Map-mode odometry under one live camera.

The same entries, stream and window as ``odometry.py``'s keyframe cell
(``init_state``, then ``odometry_step`` a frame, each pose read to the
host before the next frame); the configuration's ``map_budget`` puts the
program in map mode, tracking against a voxel-fused local map through
the engine ``map_nn`` names. The check's reference is
``reference/odometry_map.py``, and besides the pose, the promotion and
the new keyframe it compares the fused map on promotions and the
program's nearest-neighbour answers.

The window keeps only the steps the check and ``kernel_shapes`` draw,
sampled as they pass (``Sample``), where the keyframe cell keeps every
state: a map-mode state holds its own fused map and hash after each
promotion, so keeping every one grows the device's memory by a few
megabytes a promotion all through the window, and each promotion then
waits on new allocations that a deployment, which holds one state,
never makes.
"""

from __future__ import annotations

import heapq
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.reference import odometry_map as reference
from perfbench.reference.common import Precision, rotation_angle
from perfbench.systems import odometry
from perfbench.systems.odometry import kf_gap

K3_SAMPLE = 16  # recorded steps K3's mean pairs a launch is worked out from
NN_TOLERANCE = (1e-5, 1e-3)  # |hash d2 - brute d2| allowed: absolute + relative to d2


class Sample:
    """The window's steps, of which only a seeded sample is kept.

    ``append((state before, frame, diag, pose on the host))`` is called
    once a step, as the keyframe cell's window does with its list. A
    step's promotion is read from the step after it: map mode replaces
    the map's tensors exactly when it fuses, so nothing is read from the
    device. Each step draws a key; the ``uniform`` steps with the
    smallest keys, and the ``promoted`` promoted steps with the smallest
    keys of a second draw, stay (uniform samples without replacement),
    each with the state after it where it promoted; the rest are dropped
    as the window goes on. ``settle`` gives the last step the window's
    final state."""

    def __init__(self, seed: int, uniform: int, promoted: int):
        self.keys = np.random.default_rng(seed)
        self.k = (uniform, promoted)
        self.heaps = ([], [])  # max-heaps of (-key, index, step)
        self.n = 0
        self.pending = None

    def __len__(self):
        return self.n

    def append(self, step):
        state, f, diag, pose = step
        if self.pending is not None:
            self.settle(state)
        self.pending = SimpleNamespace(i=self.n, state=state, f=f, diag=diag, pose=pose, after=None,
                                       promoted=False)
        self._offer(0, self.pending)
        self.n += 1

    def settle(self, after):
        """The pending step's promotion, from the state after it."""
        s, self.pending = self.pending, None
        if s is None or after.map_points is s.state.map_points:
            return
        s.after, s.promoted = after, True
        self._offer(1, s)

    def _offer(self, which: int, step):
        heap, key = self.heaps[which], float(self.keys.random())
        if len(heap) < self.k[which]:
            heapq.heappush(heap, (-key, step.i, step))
        elif -key > heap[0][0]:
            heapq.heapreplace(heap, (-key, step.i, step))

    def uniform(self):
        """The uniform sample, smallest key first."""
        return [s for _, _, s in sorted(self.heaps[0], key=lambda e: -e[0])]

    def drawn(self):
        """Every kept step, in window order."""
        return sorted({s.i: s for _, _, s in self.heaps[0] + self.heaps[1]}.values(), key=lambda s: s.i)


class Cell(odometry.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.steps = Sample(seed, max(traffic["check_steps"], K3_SAMPLE), traffic["check_promotions"])

    def window(self, seconds: float, rec):
        super().window(seconds, rec)
        self.steps.settle(self.state)

    def kernel_shapes(self) -> dict:
        """K3+K4's (mean pairs, queries, table rows) a launch: the pairs at
        each sampled step's solved pose (a launch's pose moves a few
        millimetres within a step)."""
        from perfbench.counts import k3

        cfg, cam = self.config["settings"], self.config["camera"]
        sample = self.steps.uniform()[:K3_SAMPLE]
        if not sample:
            return {}
        counts = []
        for s in sample:
            feat = reference.features(self.frames[s.f], cam, cfg, int(s.state.frame_index) * 97)
            pose = torch.from_numpy(s.pose).to(s.state.kf_pose.device).double()
            T = torch.linalg.inv(s.state.kf_pose.double()) @ pose
            src = (feat.src[feat.src_mask].double() @ T[:3, :3].T + T[:3, 3]).cpu().numpy()
            pts = s.state.map_points[s.state.map_mask].cpu().numpy()
            counts.append(k3.pairs(src, pts, cfg["map_nn_radius"]))
        return {"k3": (float(np.mean(counts)), cfg["point_budget"], int(self.state.map_hash.table.shape[0]))}

    def check(self, prec: Precision = Precision()):
        """(numbers {name: value}, answers compared).

        As the keyframe cell's: each sampled step starts the reference
        from the program's own state before it (pose, keyframe pose, map,
        frame index), and the bootstrap (the first keyframe and the map
        fused from it) is compared alone. The sample is ``check_steps``
        steps of the window and ``check_promotions`` of its promotions
        (``Sample``). On the steps both promote, the new keyframe and the
        fused map are compared; on every sampled step, the program's hash
        answers at the reference's solved source points against the
        reference's brute ones."""
        cfg, cam, tr = self.config["settings"], self.config["camera"], self.traffic
        uniform = {s.i for s in self.steps.uniform()[:tr["check_steps"]]}
        promoted = {s.i for _, _, s in self.steps.heaps[1]}
        zero = dict(pose_t_gap_m=0.0, pose_r_gap_rad=0.0, promote_mismatch=0.0, kf_gap=0.0, kf_mask_mismatch=0.0,
                    map_gap_p99_m=0.0, map_count_gap=0.0, nn_mismatch=0.0)
        feat, fused = reference.init(self.frames[self.start], cam, cfg)
        rows = [dict(zero, **kf_gap(self.init, feat), **map_gap(self.init, fused, cfg))]
        for s in self.steps.drawn():
            if s.i not in uniform | promoted:
                continue
            state, pose = s.state, s.pose
            ref = reference.step(state.pose, state.kf_pose, state.map_points, state.map_normals, state.map_mask,
                                 int(state.frame_index), self.frames[s.f], cam, cfg, prec)
            said = bool(s.diag.promoted)
            row = dict(zero,
                       pose_t_gap_m=float(np.abs(pose[:3, 3].astype(np.float64) - ref.pose[:3, 3]).max()),
                       pose_r_gap_rad=float(rotation_angle(torch.from_numpy(pose[:3, :3]),
                                                           torch.from_numpy(ref.pose[:3, :3]))),
                       promote_mismatch=float(said != ref.promoted and ref.margin > 1e-3),
                       nn_mismatch=nn_mismatch(state, ref))
            if said != s.promoted:  # the step's flag and its map disagree on whether it fused
                row["promote_mismatch"] += 1.0
            if s.promoted and ref.promoted:
                gap = map_gap(s.after, ref.map, cfg, row["pose_t_gap_m"], row["pose_r_gap_rad"])
                row.update(kf_gap(s.after, ref.features), **gap)
            rows.append(row)
        numbers = {k: max(r[k] for r in rows) for k in zero}
        for k in ("promote_mismatch", "nn_mismatch"):
            numbers[k] = sum(r[k] for r in rows)
        worst = max(rows, key=lambda r: r.get("map_count_raw", 0))
        self.detail = {k: worst.get(k, 0) for k in ("map_count_raw", "map_near_face")}
        return numbers, len(rows)


def nn_mismatch(state, ref) -> float:
    """Gated source points whose squared distance from the program's hash
    (``voxelhash.query`` on the state's own hash, at the reference's
    solved source points) differs from the reference's brute one there by
    more than ``NN_TOLERANCE``; 0 where a tile's range overflowed (the
    hash is exact only without), or the program has no hash."""
    from perception_tpu_torch.ops import voxelhash

    if state.map_hash.points.shape[0] != state.map_points.shape[0]:
        return 0.0
    _, d2, overflow = voxelhash.query(state.map_hash, ref.src_t, return_stats=True)
    if float(overflow) > 0:
        return 0.0
    a, r = NN_TOLERANCE
    return float(((d2 - ref.src_d2).abs() > a + r * ref.src_d2)[ref.gate].sum())


def _nearest_m(a: torch.Tensor, b: torch.Tensor, tile: int = 1024) -> torch.Tensor:
    """Each row of ``a``'s distance to its nearest row of ``b``, in float64."""
    b = b.double()
    return torch.cat([torch.cdist(a[s:s + tile].double(), b, compute_mode="donot_use_mm_for_euclid_dist").amin(1)
                      for s in range(0, a.shape[0], tile)])


def map_gap(state, ref: "reference.Map", cfg: dict, pose_t_gap: float = 0.0, pose_r_gap: float = 0.0) -> dict:
    """The map a state holds against the reference's.

    - ``map_gap_p99_m``: the 99th percentile of each valid point's
      distance to the nearest centroid the reference formed before
      decimating, and, where the reference kept every voxel, of each of
      its points' distance to the state's nearest; the larger. Where the
      voxels pass ``map_budget``, a voxel that rounding moves to a
      neighbouring cell shifts the evenly spaced pick of every voxel after
      it, so the kept sets are compared only as subsets of the
      reference's voxels.
    - ``map_count_gap``: the gap in valid points beyond what rounding can
      explain. A re-anchored map point within ``2 (pose_t_gap +
      pose_r_gap |p|) + 1 um`` of a voxel face (the step's own pose gaps
      and a micrometre of rounding) may fall in the next voxel in the
      program and so add or remove one voxel; the keyframe's points are
      the same on both sides (``kf_gap`` 0). ``map_count_raw`` and
      ``map_near_face`` are the two parts, for the record."""
    mine = state.map_points[state.map_mask]
    raw = abs(mine.shape[0] - int(ref.mask.sum()))
    moved = ref.inputs[ref.from_map]
    margin = 2.0 * (pose_t_gap + pose_r_gap * torch.linalg.vector_norm(moved.double(), dim=-1)) + 1e-6
    near = int(reference.near_face(moved, ref.origin, float(np.float32(cfg["map_voxel"])), margin).sum())
    out = {"map_count_gap": float(max(raw - near, 0)), "map_count_raw": raw, "map_near_face": near}
    ways = [(mine, ref.voxels)]
    if ref.voxels.shape[0] == int(ref.mask.sum()):
        ways.append((ref.voxels, mine))
    if not mine.shape[0] or not ref.voxels.shape[0]:
        return dict(out, map_gap_p99_m=0.0 if mine.shape[0] == ref.voxels.shape[0] else float("inf"))
    return dict(out, map_gap_p99_m=max(float(torch.quantile(_nearest_m(x, y), 0.99)) for x, y in ways))
