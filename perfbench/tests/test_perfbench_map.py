"""The cells ``odom.map32k_hash`` and ``cuboid.rig8`` on the CPU at a small
size, K3's counts, and the map cell's new per-layer readers.

The map cell runs map mode on the voxel hash through ``odometry_step``
(K3+K4's plain version here) and is held to ``reference/odometry_map.py``:
the port reads correct, the control and planted faults do not. Its
per-layer readers read the spans of a small window under a CPU profiler;
the two that read the device trace are given synthetic device intervals
(a CPU run has no device trace)."""

import importlib
import itertools
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from small_cells import ROOT, SEED, _small_camera
from perfbench import control, harness, trace
from perfbench.counts import k3, peaks
from perfbench.systems.record import Window
from perception_tpu_torch.utils import profiler

CPU = torch.device("cpu")
MAP = "odom.map32k_hash"
RIG = "cuboid.rig8"
NEW_METRICS = ("host_ms.odom.track_map", "device_idle_pct.odom.track_map", "host_ms.odom.map_fuse",
               "k3_roofline_pct")


def small_map(config, traffic):
    """The map cell at 160x120 with 512 / 2048 points and a 2048-row map over a 60-frame sweep."""
    _small_camera(config)
    config["settings"].update(point_budget=512, keyframe_budget=2048, map_budget=2048)
    traffic.update(check_steps=4, check_promotions=2, warmup_steps=1)
    traffic["scene"]["frames"] = 60


def small_rig(config, traffic):
    """The rig cell at 160x120: one call of its 8 frames to warm up, one compared."""
    _small_camera(config)
    traffic.update(pool=8, orders=1, warmup_calls=1, check_calls=1)


SMALL = {MAP: small_map, RIG: small_rig}


def run(cell, seed=SEED, seconds=1.0):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device=CPU, edit=SMALL[cell])[0]


def brute_pairs(q, p, cell, origin):
    cq = np.floor((q - origin) / cell)
    cp = np.floor((p - origin) / cell)
    return int((np.abs(cq[:, None, :] - cp[None]).max(-1) <= 1).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_pairs_equal_a_brute_count(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, (400, 3))
    pts[:100] = np.round(pts[:100] / 0.06) * 0.06 + 1e-9  # points on cell faces
    q = np.concatenate([rng.uniform(-0.4, 0.4, (300, 3)), [[5.0, 5.0, 5.0]]])  # one far from every point
    origin = pts.min(0) - 0.06
    assert k3.pairs(q, pts, 0.06) == brute_pairs(q, pts, 0.06, origin)
    assert k3.pairs(q, pts, 0.06, origin=np.zeros(3)) == brute_pairs(q, pts, 0.06, np.zeros(3))
    assert k3.pairs(q[:0], pts, 0.06) == 0


def test_k3_ops_bytes_and_bound():
    # one cell a query, 5 points in each of its 27 cells
    grid = np.array(list(itertools.product(range(3), repeat=3)), np.float64) * 0.06 + 0.03
    pts = np.repeat(grid, 5, axis=0)
    q = np.array([[0.09, 0.09, 0.09]])
    assert k3.pairs(q, pts, 0.06, origin=np.zeros(3)) == 27 * 5
    assert k3.ops(135, 1, 1024) == 8 * 135
    assert k3.nbytes(135, 1, 1024) == 32 * 1024 + 20
    # the cell's shape: 8192 queries over the 32768-row map's 34816-row table is bound by bytes
    # below 6,700 pairs a query
    t, bound = peaks.bound_s(k3.ops(8192 * 100, 8192, 34816), k3.nbytes(8192 * 100, 8192, 34816))
    assert bound == "bytes" and t == pytest.approx((32 * 34816 + 20 * 8192) / peaks.HBM_BYTES)


@pytest.mark.parametrize("cell", [MAP, RIG])
def test_port_agrees_with_reference(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    _, _, config, _ = harness.cell_spec(cell)
    assert set(r["checks"]) == set(config["limits"])
    assert set(r["metrics"]) == {"cuboid_fps" if cell == RIG else "odom_fps", "setup_s"}


def test_map_control_fails():
    r = control.readings(MAP, 3, 2.0, CPU, edit=small_map)
    _, _, config, _ = harness.cell_spec(MAP)
    limits = config["limits"]
    assert set(r["program"]) == set(r["control"]) == set(limits)
    assert all(r["program"][k] <= limits[k] for k in limits)
    assert any(r["control"][k] > limits[k] for k in limits)


def _fault(monkeypatch, fault):
    from perception_tpu_torch.models.slam import odometry
    from perception_tpu_torch.ops.kernels import voxelhash_query as vq

    if fault == "fuse_drops_half":  # the keyframe's second half never reaches the map
        real = odometry._fuse_map

        def broken(map_pts, map_nrm, map_mask, kf_pts, kf_norm, kf_mask, cfg):
            half = torch.arange(kf_mask.shape[0]) < kf_mask.shape[0] // 2
            return real(map_pts, map_nrm, map_mask, kf_pts, kf_norm, kf_mask & half, cfg)

        monkeypatch.setattr(odometry, "_fuse_map", broken)
    else:  # the hash's answer is one row off where it found one
        real = vq.voxelhash_query_reference

        def broken(*a):
            idx, d2 = real(*a)
            return idx + (d2 < 1.0).to(idx.dtype), d2 * 1.5

        monkeypatch.setattr(vq, "voxelhash_query_reference", broken)


@pytest.mark.parametrize("fault", ["fuse_drops_half", "hash_off_by_one"])
def test_faults_come_out_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault)
    r = run(MAP, seconds=2.0)
    assert not r["correct"] and r["failed"] == 0


def test_new_metrics_read_a_small_window():
    """A window of the small map cell under a CPU profiler: the two span
    readers read; on synthetic device intervals (K3's two kernels inside
    every track_map span, nothing else) the idle share inside track_map
    and K3's roofline share read what those intervals give."""
    _, _, config, traffic = harness.cell_spec(MAP)
    small_map(config, traffic)
    config["settings"]["kf_translation"] = 0.0  # every step promotes, however few the window holds
    sut = importlib.import_module(f"perfbench.systems.{config['system']}").Cell(config, traffic, SEED, CPU)
    sut.setup()
    profiler.clear_spans()
    rec = Window()
    with profile(activities=[ProfilerActivity.CPU]):
        sut.window(2.0, rec)
    records = [s for s in profiler.spans() if rec.start <= s.t0 < rec.end]
    track = [s for s in records if s.name == "odometry.track_map"]
    ops = []
    for s in track:  # a quarter of each span busy, in the span's 11 K3 launches
        dt = (s.t1 - s.t0) / 4 / 11
        for j in range(11):
            a = s.t0 + j * dt
            ops += [trace.DeviceOp("void voxelhash_scan_kernel(float const*)", a, a + dt / 2),
                    trace.DeviceOp("voxelhash_merge_kernel(int const*)", a + dt / 2, a + dt)]
    ctx = SimpleNamespace(window=rec, ops=ops, kernel_shapes=sut.kernel_shapes())
    values = {m: harness.reader(m)(ctx) for m in NEW_METRICS}
    profiler.clear_spans()
    assert values["host_ms.odom.track_map"] == pytest.approx(
        1e3 * sum(s.t1 - s.t0 for s in track) / rec.units)
    assert 0 < values["host_ms.odom.map_fuse"] < values["host_ms.odom.track_map"] * 10
    assert values["device_idle_pct.odom.track_map"] == pytest.approx(75.0)
    pairs, queries, rows = ctx.kernel_shapes["k3"]
    assert pairs > 0 and queries == 512 and rows == 3072
    launch_s = sum(o.end - o.start for o in ops) / (11 * len(track))
    least, _ = peaks.bound_s(k3.ops(pairs, queries, rows), k3.nbytes(pairs, queries, rows))
    assert values["k3_roofline_pct"] == pytest.approx(100 * least / launch_s)


def test_map_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import perfbench.reference.odometry_map, perfbench.counts.k3\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "perception_tpu", "perception_tpu_torch",
                                          "benchmarks"}


def test_near_face_and_the_count_gap_it_discounts():
    from perfbench.reference import odometry_map as reference
    from perfbench.systems import odometry_map as system

    pts = torch.tensor([[0.0100, 0.0100, 0.0100], [0.0199995, 0.01, 0.01], [0.05, 0.0400004, 0.05]])
    origin = torch.zeros(3)
    assert reference.near_face(pts, origin, 0.02, 1e-6).tolist() == [False, True, True]
    assert reference.near_face(pts, origin, 0.02, torch.tensor([1e-2, 1e-7, 1e-7])).tolist() == [True, False, False]
    # a map of one point against a reference of two, one of them a re-anchored map point on a face
    state = SimpleNamespace(map_points=pts[:1].clone(), map_mask=torch.tensor([True]))
    ref = reference.Map(pts[:2], torch.zeros(2, 3), torch.tensor([True, True]), pts[:2], pts[:2],
                        torch.tensor([False, True]), origin)
    gap = system.map_gap(state, ref, {"map_voxel": 0.02})
    assert (gap["map_count_raw"], gap["map_near_face"], gap["map_count_gap"]) == (1, 1, 0.0)
    ref = ref._replace(from_map=torch.tensor([False, False]))  # a keyframe point: no discount
    assert system.map_gap(state, ref, {"map_voxel": 0.02})["map_count_gap"] == 1.0


def _sampled_window(seed, n=200, every=5, uniform=8, promoted=4):
    """A window of ``n`` stand-in steps through ``Sample``, one promotion
    every ``every`` steps (a promotion replaces the map's tensor);
    returns the sample and weak references to every state."""
    import weakref

    from perfbench.systems.odometry_map import Sample

    class State(SimpleNamespace):
        pass

    sample, refs = Sample(seed, uniform, promoted), []
    state = State(map_points=torch.zeros(1))
    for i in range(n):
        fused = i % every == every - 1
        new = State(map_points=torch.zeros(1) if fused else state.map_points)
        sample.append((state, i, SimpleNamespace(promoted=torch.tensor(fused)), np.eye(4)))
        refs.append(weakref.ref(state))
        state = new
    sample.settle(state)
    return sample, refs, state


def test_window_sample_keeps_a_bounded_seeded_sample():
    import gc

    sample, refs, last = _sampled_window(SEED)
    gc.collect()
    assert len(sample) == 200 and len(sample.uniform()) == 8
    promos = [s for _, _, s in sample.heaps[1]]
    assert len(promos) == 4 and all(s.promoted and s.i % 5 == 4 and s.after is not None for s in promos)
    assert all(s.after.map_points is not s.state.map_points for s in promos)
    # only the kept steps' states, each with the state after it where it promoted, stay alive
    kept = sample.drawn()
    alive = {i for i, r in enumerate(refs) if r() is not None}
    assert alive == {s.i for s in kept} | {s.i + 1 for s in kept if s.promoted}
    assert [s.i for s in sample.drawn()] == sorted({s.i for s in sample.uniform()} | {s.i for s in promos})
    # the same seed draws the same steps; the final step's promotion comes from the window's last state
    again, _, _ = _sampled_window(SEED)
    assert [s.i for s in again.drawn()] == [s.i for s in sample.drawn()]
    tail, _, _ = _sampled_window(SEED, n=5, promoted=5)
    assert [s.i for _, _, s in tail.heaps[1]] == [4]


def test_window_sample_is_uniform():
    """Each step is kept in the uniform sample as often as any other, and
    each promotion in the promotions' sample, over many seeds."""
    n, every, k, kp, seeds = 60, 3, 6, 4, 3000
    hits, promo_hits = np.zeros(n), np.zeros(n)
    for seed in range(seeds):
        sample, _, _ = _sampled_window(seed, n=n, every=every, uniform=k, promoted=kp)
        hits[[s.i for s in sample.uniform()]] += 1
        promo_hits[[s.i for _, _, s in sample.heaps[1]]] += 1
    expect = seeds * k / n
    assert np.abs(hits - expect).max() < 5 * np.sqrt(expect)
    promo = np.arange(n) % every == every - 1
    expect_p = seeds * kp / promo.sum()
    assert promo_hits[~promo].sum() == 0
    assert np.abs(promo_hits[promo] - expect_p).max() < 5 * np.sqrt(expect_p)
