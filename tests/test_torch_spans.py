"""The port's spans and launch counter (``utils/profiler.py``).

On the CPU: with no ``torch.profiler`` active a span records nothing and
the cuboid and odometry entries give bit-equal outputs with and without
an active profiler; with one active, each call into an entry leaves one
root span and its stages' spans, nested by ``parent`` and sharing one
``unit``, children inside their parent, ``0 <= cpu_s <= t1 - t0`` (up to
one step of the thread's CPU clock, 10 ms on a host that counts CPU time
by scheduler ticks, as the card's host does), on ``time.perf_counter``;
``trace`` exports each span name as a user annotation; the span buffer
holds at its capacity and counts what it drops; ``count_launch`` counts a wrapper's launches and adds each to the
innermost recording span. The inputs are the benchmark's cells at the
160x120 size of ``perfbench/tests/small_cells.py``.

On a CUDA card (marked ``cuda``, skipped without one): K1 launches once
in each ``cuboid.segment_ground_plane``, K2 ``icp_iterations`` times in
each ``odometry.track_keyframe`` and K3+K4 ``icp_iterations + 1`` times in
each ``odometry.track_map`` (hash engine), and the wrappers' ``launches``
and ``launches_by_shape`` grow by exactly those counts at the calls'
shapes. This file imports neither jax nor the JAX package, so it runs on
the card with ``python -m pytest tests/test_torch_spans.py -q
--noconftest -o addopts=``.
"""

import importlib
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
from perception_tpu_torch.ops.kernels.ransac_score import ransac_score
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query
from perception_tpu_torch.utils import profiler
from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("perfbench_small_cells", ROOT / "perfbench/tests/small_cells.py")
small_cells = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(small_cells)

CUBOID = ("cuboid.pipeline", ("cuboid.segment_ground_plane", "cuboid.box_filter", "cuboid.estimate_cuboid_pose"))
KEYFRAME = ("odometry.step", ("odometry.frame_features", "odometry.track_keyframe", "odometry.promote"))
MAP = ("odometry.step", ("odometry.frame_features", "odometry.track_map", "odometry.promote"))
MAP_SETTINGS = {"map_budget": 2048, "map_nn": "hash"}


def make_cell(name, device, **settings):
    """Cell ``name`` of the benchmark at 160x120, set up on ``device``."""
    _, _, config, traffic = harness.cell_spec(name)
    small_cells.SMALL[name](config, traffic)
    config["settings"].update(settings)
    cell = importlib.import_module(f"perfbench.systems.{config['system']}").Cell(
        config, traffic, small_cells.SEED, device)
    cell.setup()
    return cell


def call(cell, i=0):
    """One call into the cell's entry: the cuboid batch ``i``, or one
    odometry step from the set-up's state on its next frame."""
    if hasattr(cell, "batches"):
        return cell._call(i % len(cell.batches))
    return cell._step(cell.state, (cell.start + cell.next + i) % cell.period)


def tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in tensors(v)]


def profiled(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)):
        return fn()


@pytest.fixture(scope="module")
def cells():
    cpu = torch.device("cpu")
    return {"cuboid": make_cell(small_cells.CUBOID, cpu), "keyframe": make_cell(small_cells.ODOM, cpu),
            "map": make_cell(small_cells.ODOM, cpu, **MAP_SETTINGS)}


@pytest.fixture
def fresh():
    profiler.clear_spans()
    yield
    profiler.clear_spans()


@pytest.mark.parametrize("kind", ["cuboid", "keyframe", "map"])
def test_off_records_nothing_and_outputs_are_bit_equal(cells, fresh, kind):
    cell = cells[kind]
    off = tensors(call(cell))
    assert profiler.span("x") is profiler.span("y")  # one shared no-op
    assert profiler.spans() == []
    on = tensors(profiled(lambda: call(cell)))
    assert profiler.spans()
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))


def thread_clock_step() -> float:
    """The largest of a few steps of ``time.thread_time`` on this host."""
    steps = []
    for _ in range(3):
        t0 = time.thread_time()
        while (t1 := time.thread_time()) == t0:
            pass
        steps.append(t1 - t0)
    return max(steps)


def check_calls(records, root, children, calls):
    """Each call left its root and, under it, each child once: one unit a
    call, parents by id, children inside their parent, 0 <= cpu_s <= wall
    (up to one step of the thread's CPU clock)."""
    step = thread_clock_step()
    by_id = {s.id: s for s in records}
    roots = [s for s in records if s.name == root and s.parent is None]
    assert len(roots) == calls and len({r.unit for r in roots}) == calls
    for r in roots:
        assert r.unit == r.id
        mine = [s for s in records if s.unit == r.unit]
        assert sorted(s.name for s in mine if s.parent == r.id) == sorted(children)
        for s in mine:
            assert s.t0 <= s.t1 and 0.0 <= s.cpu_s <= s.t1 - s.t0 + step
            if s.parent is not None:
                p = by_id[s.parent]
                assert p.unit == s.unit and p.t0 <= s.t0 <= s.t1 <= p.t1
    return roots


@pytest.mark.parametrize("kind, names", [("cuboid", CUBOID), ("keyframe", KEYFRAME), ("map", MAP)])
def test_spans_nest_by_call(cells, fresh, kind, names):
    cell = cells[kind]
    profiled(lambda: [call(cell, i) for i in range(2)])
    records = profiler.spans()
    roots = check_calls(records, *names, calls=2)
    assert roots[0].t1 <= roots[1].t0
    assert {s.name for s in records} == {names[0], *names[1]}
    assert all(s.launches == {} for s in records)  # the CPU takes the kernels' plain versions
    if profiler._RUSAGE_THREAD is not None:
        assert all(isinstance(s.nivcsw, int) and s.nivcsw >= 0 for s in records)


def test_trace_exports_each_span_as_a_user_annotation(cells, fresh, tmp_path):
    with profiler.trace(str(tmp_path)):
        for kind in cells:
            call(cells[kind])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {CUBOID[0], *CUBOID[1], KEYFRAME[0], *KEYFRAME[1], *MAP[1]} <= annotations


def test_buffer_holds_its_capacity_and_counts_drops(fresh, monkeypatch):
    monkeypatch.setattr(profiler, "_BUFFER", profiler.SpanBuffer(3))

    def five():
        for i in range(5):
            with profiler.span(f"s{i}"):
                pass

    profiled(five)
    assert [s.name for s in profiler.spans()] == ["s2", "s3", "s4"]
    assert profiler.spans_dropped() == 2
    profiler.clear_spans()
    assert profiler.spans() == [] and profiler.spans_dropped() == 0


def test_span_times_are_perf_counter_and_count_time_off_cpu(fresh):
    def sleep():
        before = time.perf_counter()
        with profiler.span("outer"):
            with profiler.span("sleep"):
                time.sleep(0.05)
        return before, time.perf_counter()

    before, after = profiled(sleep)
    inner, outer = profiler.spans()
    assert (inner.name, outer.name) == ("sleep", "outer") and inner.parent == outer.id
    assert before <= outer.t0 <= inner.t0 and inner.t1 <= outer.t1 <= after
    assert inner.t1 - inner.t0 >= 0.05 and inner.t1 - inner.t0 - inner.cpu_s >= 0.04 - thread_clock_step()


def test_count_launch_counts_and_attributes_to_the_innermost_span(fresh):
    @profiler.counts_launches
    def kernel():
        pass

    profiler.count_launch(kernel, (1, 2))  # not recording: counted, in no span

    def nested():
        with profiler.span("outer"):
            profiler.count_launch(kernel, (1, 2))
            with profiler.span("inner"):
                profiler.count_launch(kernel, (3, 4))
                profiler.count_launch(kernel, (3, 4))

    profiled(nested)
    assert kernel.launches == 4 and kernel.launches_by_shape == {(1, 2): 2, (3, 4): 2}
    inner, outer = profiler.spans()
    assert inner.launches == {"kernel": 2} and outer.launches == {"kernel": 1}
    for wrapper in (ransac_score, gn_system_packed, voxelhash_query):
        assert isinstance(wrapper.launches, int) and hasattr(wrapper.launches_by_shape, "most_common")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def launch_counts():
    return {w.__name__: (w.launches, dict(w.launches_by_shape))
            for w in (ransac_score, gn_system_packed, voxelhash_query)}


def grown(before, after):
    """Each wrapper's launches, and its launches by shape, since ``before``."""
    out = {}
    for name, (n, shapes) in after.items():
        n0, shapes0 = before[name]
        out[name] = (n - n0, {k: v - shapes0.get(k, 0) for k, v in shapes.items() if v != shapes0.get(k, 0)})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cuboid", "keyframe", "map"])
def test_cuda_kernels_counted_in_their_spans(cuda_device, fresh, kind):
    name = small_cells.CUBOID if kind == "cuboid" else small_cells.ODOM
    cell = make_cell(name, cuda_device, **(MAP_SETTINGS if kind == "map" else {}))
    calls = 3
    before = launch_counts()
    profiled(lambda: [tensors(call(cell, i))[0].cpu() for i in range(calls)],
             activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA))
    delta = grown(before, launch_counts())
    records = profiler.spans()
    s = cell.config["settings"]
    if kind == "cuboid":
        wrapper, stage, per_call = "ransac_score", "cuboid.segment_ground_plane", 1
        shapes = {(cell.traffic["batch"], s["work_capacity"], s["ransac_hypotheses"]): calls}
    elif kind == "keyframe":
        wrapper, stage, per_call = "gn_system_packed", "odometry.track_keyframe", s["icp_iterations"]
        shapes = None  # one (1, Np, Mp) at the padded budgets
    else:
        wrapper, stage, per_call = "voxelhash_query", "odometry.track_map", s["icp_iterations"] + 1
        shapes = None
    check_calls(records, *(CUBOID if kind == "cuboid" else KEYFRAME if kind == "keyframe" else MAP), calls=calls)
    held = [r for r in records if r.launches]
    assert [r.name for r in held] == [stage] * calls
    assert all(r.launches == {wrapper: per_call} for r in held)
    assert delta[wrapper][0] == calls * per_call
    assert sum(delta[wrapper][1].values()) == calls * per_call and len(delta[wrapper][1]) == 1
    if shapes is not None:
        assert delta[wrapper][1] == shapes
    assert all(delta[w] == (0, {}) for w in delta if w != wrapper)
