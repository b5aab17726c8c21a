"""The port's map-mode odometry on the voxel hash against the benchmark's
plain reference of map mode (``perfbench/reference/odometry_map.py``), on
the CPU at 80x60 (K3+K4's plain version), with no JAX.

A run of ``odometry_step`` (``map_budget`` 2048, ``map_nn="hash"``) over
the benchmark's revisit sweep, under a CPU profiler; each step is held to
the reference started from the program's own state before it: the pose,
the promotion, and on promotions the new keyframe and the fused map. The
hash's answers against brute nearest within the radius, the port's fuse
against the reference's (plain and recency-weighted, with and without
decimation), and map mode's spans and counters against the promotions.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import odometry
from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
from perception_tpu_torch.ops import voxelhash
from perception_tpu_torch.utils import profiler
from perfbench.reference import odometry_map as reference
from perfbench.reference.common import SENTINEL, Precision, rotation_angle
from perfbench.scenes import room
from perfbench.systems import odometry_map as system
from perfbench.systems.odometry import kf_gap

CAMERA = {"width": 80, "height": 60, "fx": 384.0898742675781 / 8, "fy": 384.0898742675781 / 8,
          "cx": 322.4656677246094 / 8, "cy": 240.64073181152344 / 8}
SCENE = {"frames": 150, "cycles": 2.0, "x_amp": 0.5, "y_amp": 0.15, "yaw_amp": 0.08, "noise": 0.001,
         "planes": [[[0, 1.0, 0], 0.9], [[0, -1.0, 0], 0.9], [[0, 0, 1.0], 3.0], [[1.0, 0, 0], 1.3],
                    [[-1.0, 0, 0], 1.3]]}
STEPS = 20
SEED = 2**31 + 22
# Rounding alone parts the two: the program's posed points (explicit
# sums), cell-sorted source and float32 solve against the reference's
# products and float64 solve. Measured under 4e-7 m and rad here; the
# bounds sit 25 times above, far under a step's motion (centimetres).
POSE_T_M, POSE_R_RAD, MAP_P99_M = 1e-5, 1e-5, 1e-5


def settings(**over):
    """The cell's settings at 80x60: a pixel spans 8 times the width it
    does at 640x480, so the normals' edge gate is 0.2 m (at 0.05 the far
    wall loses its normals and a step keeps a few dozen points, too few
    for a well-posed solve), and promotions come at 8 cm of travel, so
    the 20 steps hold several."""
    s = {"point_budget": 512, "keyframe_budget": 2048, "icp_iterations": 10, "max_correspondence_distance": 0.25,
         "huber_delta": 0.02, "damping": 1e-05, "min_depth": 0.2, "max_depth": 5.0, "normal_max_edge": 0.2,
         "map_budget": 2048, "map_voxel": 0.02, "map_decay": 1.0, "map_nn_radius": 0.06, "map_nn": "hash",
         "kf_translation": 0.08, "kf_rotation": 0.2, "kf_min_overlap": 0.5}
    s.update(over)
    return s


@pytest.fixture(scope="module")
def run():
    cpu = torch.device("cpu")
    frames = room.render(CAMERA, SCENE, SEED, cpu)
    cfg = settings()
    camera = PinholeCamera.from_K([[CAMERA["fx"], 0, CAMERA["cx"]], [0, CAMERA["fy"], CAMERA["cy"]], [0, 0, 1]],
                                  width=CAMERA["width"], height=CAMERA["height"])
    state = init_state(camera, frames[0], OdometryConfig(**cfg))
    steps = []
    before = dict(odometry.map_updates)
    profiler.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for f in range(1, STEPS + 1):
            new, diag = odometry_step(state, frames[f], camera, OdometryConfig(**cfg))
            steps.append((state, f, diag, new))
            state = new
    records = profiler.spans()
    profiler.clear_spans()
    updates = {k: odometry.map_updates[k] - before.get(k, 0) for k in ("fuses", "hash_builds")}
    promoted = [bool(diag.promoted) for _, _, diag, _ in steps]
    assert sum(promoted) >= 2, "the sweep must promote at least twice"
    return SimpleNamespace(frames=frames, cfg=cfg, steps=steps, records=records, updates=updates,
                           promoted=promoted)


def reference_step(run, i, prec=Precision()):
    state, f, _, _ = run.steps[i]
    return reference.step(state.pose, state.kf_pose, state.map_points, state.map_normals, state.map_mask,
                          int(state.frame_index), run.frames[f], CAMERA, run.cfg, prec)


@pytest.mark.parametrize("i", range(STEPS))
def test_step_matches_the_reference_from_the_programs_state(run, i):
    state, _, _, new = run.steps[i]
    ref = reference_step(run, i)
    pose = new.pose.numpy()
    gap_t = np.abs(pose[:3, 3].astype(np.float64) - ref.pose[:3, 3]).max()
    gap_r = float(rotation_angle(new.pose[:3, :3], torch.from_numpy(ref.pose[:3, :3])))
    assert gap_t <= POSE_T_M and gap_r <= POSE_R_RAD
    if ref.margin > 1e-3:
        assert run.promoted[i] == ref.promoted
    if run.promoted[i] and ref.promoted:
        assert kf_gap(new, ref.features) == {"kf_gap": 0.0, "kf_mask_mismatch": 0.0}
        gap = system.map_gap(new, ref.map, run.cfg, gap_t, gap_r)
        assert gap["map_count_raw"] == 0 and gap["map_gap_p99_m"] <= MAP_P99_M
    else:
        assert new.map_points is state.map_points
    assert system.nn_mismatch(state, ref) == 0


def test_bootstrap_map_matches_the_reference(run):
    feat, fused = reference.init(run.frames[0], CAMERA, run.cfg)
    first = run.steps[0][0]
    assert kf_gap(first, feat) == {"kf_gap": 0.0, "kf_mask_mismatch": 0.0}
    assert system.map_gap(first, fused, run.cfg) == {"map_gap_p99_m": 0.0, "map_count_gap": 0.0,
                                                     "map_count_raw": 0, "map_near_face": 0}


def _brute_d2(q, pts, mask):
    """Squared distance of each query to the nearest valid point, in the
    kernel's form ``(dx*dx + dy*dy) + dz*dz``."""
    p = pts[mask]
    d = q[:, None, :] - p[None]
    return ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]).amin(1)


def test_hash_query_is_brute_nearest_within_the_radius(run):
    r2 = run.cfg["map_nn_radius"] ** 2
    exact = 0
    for i in range(STEPS):
        state, _, _, new = run.steps[i]
        ref = reference_step(run, i)
        idx, d2, overflow = voxelhash.query(state.map_hash, ref.src_t, return_stats=True)
        if float(overflow) > 0:
            continue
        brute = _brute_d2(ref.src_t, state.map_points, state.map_mask)
        near = ref.features.src_mask & (brute <= r2)
        assert torch.equal(d2[near], brute[near])
        d = state.map_hash.points[idx.long()] - ref.src_t  # the returned point is at that distance
        assert torch.equal(((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])[near], d2[near])
        exact += int(near.sum())
    assert exact > STEPS * 100  # most steps compared, most gated points each


@pytest.mark.parametrize("decay, budget", [(1.0, 4096), (1.0, 256), (0.5, 4096), (0.5, 256)])
def test_fuse_matches_the_reference(run, decay, budget):
    """The port's ``_fuse_map`` and the reference's ``fuse`` on one map and
    a later frame's keyframe cloud: the same voxels in the same order, the
    same decimation where the voxels pass the budget (256; 4096 rows hold
    every voxel of the two 2048-row clouds)."""
    i = run.promoted.index(True)
    state = run.steps[i][3]
    f = run.steps[-1][1]
    cfg = settings(map_decay=decay, map_budget=budget)
    feat = reference.features(run.frames[f], CAMERA, cfg, 0)
    pts, nrm, mask = odometry._fuse_map(state.map_points, state.map_normals, state.map_mask, feat.kf,
                                        feat.kf_normals, feat.kf_mask, OdometryConfig(**cfg))
    ref = reference.fuse(state.map_points, state.map_normals, state.map_mask, feat.kf, feat.kf_normals,
                         feat.kf_mask, cfg)
    n = int(ref.mask.sum())
    assert torch.equal(mask, ref.mask) and (n == budget) == (budget == 256)
    assert torch.equal(pts[~mask], torch.full_like(pts[~mask], SENTINEL))
    assert (pts[mask] - ref.points[mask]).abs().max() <= 1e-6
    assert (nrm[mask] - ref.normals[mask]).abs().max() <= 1e-5


def test_map_spans_and_counters_follow_the_promotions(run):
    """Every step: the source sort inside ``odometry.track_map`` and the
    ``promote`` read inside ``odometry.promote``; every promotion: one
    ``odometry.map_fuse`` there, with the hash rebuild inside it, and one
    fuse and one rebuild on the host counters."""
    by_id = {s.id: s for s in run.records}

    def parents(name):
        return [by_id[s.parent].name for s in run.records if s.name == name]

    promotions = sum(run.promoted)
    assert parents("odometry.map_sort") == ["odometry.track_map"] * STEPS
    assert parents("odometry.map_promote_read") == ["odometry.promote"] * STEPS
    assert parents("odometry.map_fuse") == ["odometry.promote"] * promotions
    assert parents("odometry.map_hash_build") == ["odometry.map_fuse"] * promotions
    assert run.updates == {"fuses": promotions, "hash_builds": promotions}
    fused = [s.unit for s in run.records if s.name == "odometry.map_fuse"]
    roots = [s.unit for s in run.records if s.name == "odometry.step"]
    assert [roots.index(u) for u in fused] == [i for i, p in enumerate(run.promoted) if p]


def test_counts_nothing_in_keyframe_mode():
    cpu = torch.device("cpu")
    frames = room.render(CAMERA, dict(SCENE, frames=4), SEED, cpu)
    cfg = OdometryConfig(**settings(map_budget=0, kf_translation=0.0))
    camera = PinholeCamera.from_K([[CAMERA["fx"], 0, CAMERA["cx"]], [0, CAMERA["fy"], CAMERA["cy"]], [0, 0, 1]],
                                  width=CAMERA["width"], height=CAMERA["height"])
    before = dict(odometry.map_updates)
    state = init_state(camera, frames[0], cfg)
    state, diag = odometry_step(state, frames[1], camera, cfg)
    assert bool(diag.promoted) and dict(odometry.map_updates) == before
