"""Odometry's loops replayed as CUDA graphs through ``_graph.captured``:
keyframe mode's fused Gauss-Newton loop on K2 (``odometry._fused_gn``)
and map mode's hash solve on K3+K4 (``odometry._hash_solve``).

Each mode is held to its eager path: keyframe mode to ``_fused_gn`` on
the step's operands, map mode to ``eager_track_map`` below, the hash and
brute engines' solve written out as one loop (the source's cell sort,
``icp_iterations`` updates, the stats query).

On the CPU: CPU tensors never capture (``_graph.captures``,
``_graph.replays`` and the graph cache stay empty) and each step's
outputs equal the eager path's, in keyframe mode and in map mode with
the hash and brute engines; the graph key changes with the function, the
inputs' shapes and dtypes, every config field and the TF32 flags, and
not with tensor values; ``_tensor._filled``, the constant that ``const``
builds while a stream captures, equals ``torch.tensor``'s bit for bit
(-0.0, NaN, mixed rows, scalars); inside ``tallied`` ``count_launch``
counts into the block's tally alone, and counting a tally again (as a
replay does) adds it to the wrapper and the span.

On a CUDA card (marked ``cuda``, skipped without one), in keyframe mode
and on the hash, over 12 steps of the room sweep with a promotion before
the last step, at 1024 x 2048 (160x120) and 8192 x 32768 (640x480): each
step's outputs from the graph equal the eager path's from the same
inputs, bit for bit; one capture and 11 replays at the key, the kernel
counted ``icp_iterations`` (K2) or ``icp_iterations + 1`` (K3+K4) times
a step at the capture's shape; a changed ``huber_delta`` or
``map_nn_radius`` captures a second graph; a replayed step's outputs are
unchanged after 5 more replays. This file imports neither jax nor the
JAX package, so it runs on the card with ``python -m pytest
tests/test_torch_cuda_graph.py -q --noconftest -o addopts=``.
"""

import dataclasses
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perception_tpu_torch import _graph, _tensor
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import odometry
from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
from perception_tpu_torch.ops import nn, voxelhash
from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query
from perception_tpu_torch.ops.points import apply_mask
from perception_tpu_torch.utils import profiler

STEPS = 12
STRIDE = 6  # sweep poses a step: about 4 cm, so the keyframe moves within the run
SIZES = {"1024x2048": (160, 120, 1024, 2048), "8192x32768": (640, 480, 8192, 32768)}
CARD_MODES = ["keyframe", "hash"]  # the modes that capture
WRAPPERS = {"keyframe": gn_system_packed, "hash": voxelhash_query}  # the kernel each mode's graph launches
CHANGED = {"keyframe": {"huber_delta": 0.03}, "hash": {"map_nn_radius": 0.08}}
OUTPUTS = ("T", "num_corr", "fitness", "nn_overflow", "src_mask")


def room(width, height, steps=STEPS):
    """A camera and ``steps + 1`` depth frames of the room sweep."""
    fx = 384.0898742675781 * width / 640.0
    cam = PinholeCamera.from_K([fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1], width=width, height=height)
    poses = sweep_trajectory(n=300)[::STRIDE][:steps + 1]
    depths = np.stack([render_textured_room(cam, T, seed=i)[1] for i, T in enumerate(poses)])
    return cam, torch.from_numpy(depths)


def config(mode, point_budget, budget, **kw):
    """Keyframe mode with K2, or map mode with the ``mode`` engine."""
    engine = dict(fused_gn="on") if mode == "keyframe" else dict(map_budget=budget, map_nn=mode)
    return OdometryConfig(point_budget=point_budget, keyframe_budget=budget, normal_max_edge=0.2, **engine, **kw)


def eager_track_keyframe(state, src_pts, src_mask, T0, cfg):
    return odometry._fused_gn(src_pts, src_mask, state.kf_points, state.kf_normals, state.kf_mask, T0, cfg)


def eager_track_map(state, src_pts, src_mask, T0, cfg):
    """Map mode's hash and brute solves as one eager loop, from the same
    inputs as ``_track_map``: (T, num_corr, fitness, nn_overflow, src_mask)."""
    r2 = cfg.map_nn_radius**2
    if cfg.map_nn == "hash":
        vh = state.map_hash
        map_pts, nrm = vh.points, state.map_nrm_hash
        _, order = voxelhash.sort_by_cell(vh, se3.transform_points(T0, src_pts))
        src_pts, src_mask = src_pts[order], src_mask[order]

        def query(q):
            return voxelhash.query(vh, q, sort=False, return_stats=True)
    else:
        map_pts, nrm = apply_mask(state.map_points, state.map_mask), state.map_normals

        def query(q):
            return (*nn.nearest_neighbor(q, map_pts, state.map_mask), torch.zeros((), device=q.device))

    with _tensor.fp32():  # as odometry_step runs it
        T = T0
        for _ in range(cfg.icp_iterations):
            src_t = odometry._posed(T, src_pts)
            idx, d2, _ = query(src_t)
            T = odometry._gn_update(T, src_t, map_pts[idx], nrm[idx], src_mask & (d2 <= r2), cfg)
        _, d2, overflow = query(se3.transform_points(T, src_pts))
        gate = src_mask & (d2 <= r2)
        num_corr = torch.sum(gate, dtype=torch.int32)
        fitness = torch.sum(torch.where(gate, d2, 0.0)) / torch.clamp(num_corr.to(torch.float32), min=1.0)
    return T, num_corr, fitness, overflow, src_mask


@pytest.fixture
def calls(monkeypatch, mode):
    """A fresh graph cache and counters; every track call's inputs
    (state, src_pts, src_mask, T0) and outputs, in order."""
    monkeypatch.setattr(_graph, "_GRAPHS", {})
    monkeypatch.setattr(_graph, "captures", Counter())
    monkeypatch.setattr(_graph, "replays", Counter())
    name = "_track_keyframe" if mode == "keyframe" else "_track_map"
    track, recorded_calls = getattr(odometry, name), []

    def recorded(state, src_pts, src_mask, T0, cfg):
        out = track(state, src_pts, src_mask, T0, cfg)
        recorded_calls.append(((state, src_pts, src_mask, T0), out))
        return out

    monkeypatch.setattr(odometry, name, recorded)
    return recorded_calls


def run(cam, depths, cfg):
    """The diagnostics of ``odometry_step`` over the frames."""
    state, diags = init_state(cam, depths[0], cfg), []
    for depth in depths[1:]:
        state, diag = odometry_step(state, depth, cam, cfg)
        diags.append(diag)
    return diags


def assert_equals_eager(calls, cfg):
    eager_track = eager_track_keyframe if cfg.map_budget == 0 else eager_track_map
    for step, (inputs, out) in enumerate(calls):
        eager = eager_track(*inputs, cfg)
        assert len(out) == len(eager)
        for name, got, want in zip(OUTPUTS, out, eager):
            assert torch.equal(got, want), f"step {step}: {name} differs from the eager path's"


@pytest.mark.parametrize("mode", ["keyframe", "hash", "brute"])
def test_cpu_never_captures(calls, mode):
    cam, depths = room(64, 48, steps=3)
    cfg = config(mode, 256, 512, icp_iterations=4)
    diags = run(cam, depths, cfg)
    assert len(calls) == 3
    assert _graph.captures == Counter() and _graph.replays == Counter() and _graph._GRAPHS == {}
    assert_equals_eager(calls, cfg)
    assert all(int(d.num_corr) > 0 for d in diags)


def test_graph_key_holds_what_the_capture_depends_on():
    inputs, cfg, fn = (torch.zeros(8, 3), torch.ones(8, dtype=torch.bool)), OdometryConfig(), odometry._hash_solve
    key = _graph._key(fn, inputs, cfg)
    assert _graph._key(fn, tuple(torch.ones_like(t) for t in inputs), dataclasses.replace(cfg)) == key
    others = [_graph._key(odometry._fused_gn, inputs, cfg),
              _graph._key(fn, (torch.zeros(16, 3), inputs[1]), cfg),
              _graph._key(fn, (inputs[0].double(), inputs[1]), cfg)]
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        changed = value + "_" if isinstance(value, str) else value + 1
        others.append(_graph._key(fn, inputs, dataclasses.replace(cfg, **{field.name: changed})))
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        saved = flags.allow_tf32
        try:
            flags.allow_tf32 = not saved
            others.append(_graph._key(fn, inputs, cfg))
        finally:
            flags.allow_tf32 = saved
    assert key not in others and len(set(others)) == len(others)


@pytest.mark.parametrize("values", [0.0, -0.0, 1e6, float("nan"), [0.0, 0.0, 0.0, 1.0],
                                    [[1.0, -0.0], [2.0, 1.0]], [float("nan"), 0.0, -0.0], [3.0, 3.0, 7.0], []])
def test_filled_constant_equals_the_copied_one(values):
    want = torch.tensor(values, dtype=torch.float32)
    got = _tensor._filled(want, torch.device("cpu"))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # bit for bit
    if all(math.isfinite(v) for v in want.reshape(-1).tolist()):
        ints = torch.tensor(values, dtype=torch.int32)
        assert torch.equal(_tensor._filled(ints, torch.device("cpu")), ints)


def test_tallied_blocks_count_into_their_tally_alone():
    def kernel():
        pass

    profiler.counts_launches(kernel)
    profiler.count_launch(kernel, (1,))
    with profiler.tallied() as outer:
        profiler.count_launch(kernel, (1,))
        with profiler.tallied() as inner:
            profiler.count_launch(kernel, (2,), 3)
        profiler.count_launch(kernel, (2,))
    profiler.count_launch(kernel, (1,))
    assert kernel.launches == 2 and kernel.launches_by_shape == {(1,): 2}
    assert outer == {(kernel, (1,)): 1, (kernel, (2,)): 1} and inner == {(kernel, (2,)): 3}


def test_replaying_a_tally_counts_it_in_the_wrapper_and_the_span():
    def kernel():
        pass

    profiler.counts_launches(kernel)
    with profiler.tallied() as tally:
        for _ in range(10):
            profiler.count_launch(kernel, (1, 512, 1024))
    profiler.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):  # two replays
            with profiler.span("odometry.track_keyframe"):
                for (wrapper, shape), n in tally.items():
                    profiler.count_launch(wrapper, shape, n)
    spans = profiler.spans()
    profiler.clear_spans()
    assert kernel.launches == 20 and kernel.launches_by_shape == {(1, 512, 1024): 20}
    assert [s.launches for s in spans] == [{"kernel": 10}, {"kernel": 10}]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs, K2 and K3+K4 have no CPU mode")
    return torch.device("cuda", 0)


def launches(mode, cfg, state):
    """The shape a mode's graph launches its kernel at (the sizes here are
    multiples of every block and tile the kernels pick) and its launches
    a step."""
    if mode == "keyframe":
        return (1, cfg.point_budget, cfg.keyframe_budget), cfg.icp_iterations
    return (cfg.point_budget, state.map_hash.table.shape[0]), cfg.icp_iterations + 1


def fn_name(mode):
    return "_fused_gn" if mode == "keyframe" else "_hash_solve"


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", CARD_MODES)
def test_cuda_graph_equals_eager_bit_for_bit(cuda_device, calls, mode, size):
    width, height, n, m = SIZES[size]
    cam, depths = room(width, height)
    cfg = config(mode, n, m)
    wrapper = WRAPPERS[mode]
    total, by_shape = wrapper.launches, Counter(wrapper.launches_by_shape)
    diags = run(cam, depths.to(cuda_device), cfg)
    torch.cuda.synchronize()
    shape, per_step = launches(mode, cfg, calls[0][0][0])
    name = fn_name(mode)
    assert _graph.captures == {name: 1} and _graph.replays == {name: STEPS - 1}
    (graph,) = _graph._GRAPHS.values()
    assert graph.tally == {(wrapper, shape): per_step}
    assert wrapper.launches - total == STEPS * per_step
    assert wrapper.launches_by_shape - by_shape == {shape: STEPS * per_step}
    assert any(bool(d.promoted) for d in diags[:-1]), "a replay must follow a promotion"
    assert len(calls) == STEPS
    # The replays' outputs are compared only now, after every later replay.
    assert_equals_eager(calls, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CARD_MODES)
def test_cuda_changed_config_captures_a_second_graph(cuda_device, calls, mode):
    width, height, n, m = SIZES["1024x2048"]
    cam, depths = room(width, height, steps=3)
    depths = depths.to(cuda_device)
    cfg = config(mode, n, m)
    run(cam, depths, cfg)
    run(cam, depths, dataclasses.replace(cfg, **CHANGED[mode]))
    name = fn_name(mode)
    assert len(_graph._GRAPHS) == 2
    assert _graph.captures == {name: 2} and _graph.replays == {name: 4}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CARD_MODES)
def test_cuda_replayed_outputs_are_not_overwritten(cuda_device, calls, mode):
    width, height, n, m = SIZES["1024x2048"]
    cam, depths = room(width, height, steps=7)
    depths = depths.to(cuda_device)
    cfg = config(mode, n, m)
    state = init_state(cam, depths[0], cfg)
    state, _ = odometry_step(state, depths[1], cam, cfg)  # eager, then the capture
    state, diag = odometry_step(state, depths[2], cam, cfg)  # the first replay
    held = [state.pose, *diag, *calls[1][1]]
    kept = [t.clone() for t in held]
    for depth in depths[3:]:  # 5 more replays
        state, _ = odometry_step(state, depth, cam, cfg)
    assert _graph.replays == {fn_name(mode): 6}
    for before, after in zip(kept, held):
        assert torch.equal(before, after)
