"""The readers of the program's spans (``perfbench/spans.py``): on
synthetic spans and device intervals, and on the spans of a small window
of each cell run on the CPU under a profiler."""

import importlib
import sys
import types
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from small_cells import SEED, SMALL
from perfbench import harness, spans, trace
from perfbench.systems.record import Window
from perception_tpu_torch.utils import profiler
from perception_tpu_torch.utils.profiler import Span

Op = trace.DeviceOp


def S(name, id, parent, unit, t0, t1, cpu_s=0.0):
    return Span(name, id, parent, unit, t0, t1, cpu_s, 0, {})


SYNTHETIC = [  # two calls in the window [0, 10), one before it
    S("odometry.frame_features", 1, None, 1, -2.0, -1.0),
    S("odometry.frame_features", 3, 2, 2, 0.0, 1.0, 0.5),
    S("odometry.track_keyframe", 4, 2, 2, 1.0, 3.0, 2.0),
    S("odometry.step", 2, None, 2, 0.0, 4.0, 3.0),
    S("odometry.frame_features", 6, 5, 5, 5.0, 6.0, 1.0),
    S("odometry.track_keyframe", 7, 5, 5, 6.0, 8.0, 1.0),
    S("odometry.step", 5, None, 5, 5.0, 9.0, 2.5),
]


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(profiler, "spans", lambda: list(SYNTHETIC))


def _ctx(ops=None, units=2):
    return SimpleNamespace(ops=ops, window=Window(start=0.0, end=10.0, units=units))


def test_window_keeps_spans_that_begin_inside(synthetic):
    assert [s.id for s in spans.window_spans(_ctx())] == [3, 4, 2, 6, 7, 5]
    ctx = _ctx()
    ctx.window.start = 20.0
    ctx.window.end = 30.0
    assert spans.window_spans(ctx) == []


def test_host_and_offcpu_ms_per_unit(synthetic):
    ctx = _ctx()
    assert spans.host_ms_per_unit(ctx, "odometry.track_keyframe") == pytest.approx(2000.0)
    assert spans.host_ms_per_unit(ctx, "odometry.frame_features", parent="odometry.step") == pytest.approx(1000.0)
    assert spans.host_ms_per_unit(ctx, "odometry.frame_features", parent="cuboid.pipeline") is None
    assert spans.host_ms_per_unit(ctx, "cuboid.box_filter") is None
    # (4 - 3) + (4 - 2.5) seconds off the CPU over 2 units
    assert spans.offcpu_ms_per_unit(ctx, "odometry.step") == pytest.approx(1250.0)


def test_device_idle_inside_spans(synthetic):
    ops = [Op("a", 0.5, 1.5), Op("b", 1.2, 2.0), Op("c", 2.5, 6.5), Op("d", 7.0, 7.5)]
    # track_keyframe spans [1, 3) and [6, 8): busy 1.0 + 0.5 then 0.5 + 0.5 of 4 s
    assert spans.device_idle_pct_in(_ctx(ops), "odometry.track_keyframe") == pytest.approx(37.5)
    assert spans.device_idle_pct_in(_ctx(None), "odometry.track_keyframe") is None
    assert spans.device_idle_pct_in(_ctx(ops), "cuboid.estimate_cuboid_pose") is None


def test_merged_and_busy_in():
    u = spans.merged([Op("a", 0.0, 1.0), Op("b", 0.5, 1.5), Op("c", 0.6, 0.7), Op("d", 2.0, 2.5), Op("e", 2.5, 3.0)])
    assert u == [(0.0, 1.5), (2.0, 3.0)]
    starts = [a for a, _ in u]
    assert spans.busy_in(u, starts, -1.0, 4.0) == pytest.approx(trace.union_s(
        [Op("x", 0.0, 1.5), Op("y", 2.0, 3.0)]))
    assert spans.busy_in(u, starts, 1.0, 2.2) == pytest.approx(0.7)
    assert spans.busy_in(u, starts, 1.6, 1.9) == 0.0


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "perception_tpu_torch.utils.profiler", types.ModuleType("old_profiler"))
    ctx = _ctx([Op("a", 0.0, 1.0)])
    assert spans.window_spans(ctx) == []
    assert spans.host_ms_per_unit(ctx, "odometry.step") is None
    assert spans.offcpu_ms_per_unit(ctx, "odometry.step") is None
    assert spans.device_idle_pct_in(ctx, "odometry.step") is None


ROOTS = {"cuboid.replay_b64": ("cuboid.pipeline", ["host_ms.cuboid.segment", "host_ms.cuboid.box_filter",
                                                   "host_ms.cuboid.icp", "host_offcpu_ms.cuboid"]),
         "odom.live_kf32k": ("odometry.step", ["host_ms.odom.features", "host_ms.odom.track",
                                               "host_offcpu_ms.odom"])}


@pytest.mark.parametrize("cell", sorted(ROOTS))
def test_a_small_window_on_the_cpu(cell):
    """A window of the small cell under a CPU profiler: every host reader
    of the cell reads, the root spans' host time a unit is the harness's
    ``entry_s`` a unit within 3%, and the root's children sum to no more
    than it."""
    _, _, config, traffic = harness.cell_spec(cell)
    SMALL[cell](config, traffic)
    sut = importlib.import_module(f"perfbench.systems.{config['system']}").Cell(
        config, traffic, SEED, torch.device("cpu"))
    sut.setup()
    profiler.clear_spans()
    rec = Window()
    with profile(activities=[ProfilerActivity.CPU]):
        sut.window(0.5, rec)
    ctx = SimpleNamespace(window=rec, ops=None)
    root, readers = ROOTS[cell]
    for name in readers:
        value = harness.reader(name)(ctx)
        assert value >= 0 if name.startswith("host_offcpu_ms") else value > 0
    assert spans.host_ms_per_unit(ctx, root) == pytest.approx(1e3 * rec.entry_s / rec.units, rel=0.03)
    records = spans.window_spans(ctx)
    for r in spans.named(records, root):
        assert sum(s.t1 - s.t0 for s in records if s.parent == r.id) <= r.t1 - r.t0
    profiler.clear_spans()
