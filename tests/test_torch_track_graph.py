"""Keyframe odometry's fused Gauss-Newton loop replayed as a CUDA graph
(``models/slam/odometry._track_keyframe``, ``_Graph``).

On the CPU: CPU tensors never capture (``_track_keyframe.captures`` and
``.replays`` stay empty, the graph cache too) and give ``_fused_gn``'s
eager results; ``_tensor._filled``, the constant that ``const`` builds
while a stream captures, equals ``torch.tensor``'s bit for bit (-0.0,
NaN, mixed rows, scalars); inside ``tallied`` ``count_launch`` counts
into the block's tally alone, and counting a tally again (as a replay
does) adds it to the wrapper and the span.

On a CUDA card (marked ``cuda``, skipped without one), over 12 steps of
the room sweep with at least one promotion, at 1024 x 2048 (160x120) and
8192 x 32768 (640x480): each step's (T, num_corr, fitness) from the
graph equals the eager loop's from the same inputs, bit for bit; one
capture and 11 replays at the key, K2 counted ``icp_iterations`` times a
step, each replay's count the capture's tally; a changed ``huber_delta`` captures a second graph at the same
shape; a replayed step's pose, diagnostics and track outputs are
unchanged after 5 more replays. This file imports neither jax nor the JAX
package, so it runs on the card with ``python -m pytest
tests/test_torch_track_graph.py -q --noconftest -o addopts=``.
"""

import dataclasses
import functools
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perception_tpu_torch import _tensor
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import odometry
from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
from perception_tpu_torch.ops.kernels import icp_gn
from perception_tpu_torch.utils import profiler

STEPS = 12
STRIDE = 6  # sweep poses a step: about 4 cm, so the keyframe moves within the run
SIZES = {"1024x2048": (160, 120, 1024, 2048), "8192x32768": (640, 480, 8192, 32768)}


def room(width, height, steps=STEPS):
    """A camera and ``steps + 1`` depth frames of the room sweep."""
    fx = 384.0898742675781 * width / 640.0
    cam = PinholeCamera.from_K([fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1], width=width, height=height)
    poses = sweep_trajectory(n=300)[::STRIDE][:steps + 1]
    depths = np.stack([render_textured_room(cam, T, seed=i)[1] for i, T in enumerate(poses)])
    return cam, torch.from_numpy(depths)


def config(point_budget, keyframe_budget, **kw):
    return OdometryConfig(point_budget=point_budget, keyframe_budget=keyframe_budget, fused_gn="on",
                          normal_max_edge=0.2, **kw)


@pytest.fixture
def tracks(monkeypatch):
    """A fresh graph cache and counters; every ``_track_keyframe`` call's
    inputs (``_fused_gn``'s operands) and outputs, in order."""
    track = odometry._track_keyframe
    monkeypatch.setattr(odometry, "_GRAPHS", {})
    monkeypatch.setattr(track, "captures", Counter())
    monkeypatch.setattr(track, "replays", Counter())
    calls = []

    @functools.wraps(track)  # shares the counters, which the entry reaches through its own name
    def recorded(state, src_pts, src_mask, T0, cfg):
        out = track(state, src_pts, src_mask, T0, cfg)
        calls.append(((src_pts, src_mask, state.kf_points, state.kf_normals, state.kf_mask, T0), out))
        return out

    monkeypatch.setattr(odometry, "_track_keyframe", recorded)
    return track, calls


def run(cam, depths, cfg):
    """(states after each step, diags) of ``odometry_step`` over the frames."""
    state = init_state(cam, depths[0], cfg)
    states, diags = [], []
    for depth in depths[1:]:
        state, diag = odometry_step(state, depth, cam, cfg)
        states.append(state)
        diags.append(diag)
    return states, diags


def test_cpu_never_captures(tracks):
    track, calls = tracks
    cam, depths = room(64, 48, steps=3)
    cfg = config(256, 512, icp_iterations=4)
    _, diags = run(cam, depths, cfg)
    assert len(calls) == 3
    assert track.captures == Counter() and track.replays == Counter() and odometry._GRAPHS == {}
    for inputs, out in calls:
        for got, want in zip(out, odometry._fused_gn(*inputs, cfg)):
            assert torch.equal(got, want)
    assert all(int(d.num_corr) > 0 for d in diags)


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
        pytest.skip("needs a CUDA card: CUDA graphs and K2 have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_cuda_graph_equals_eager_bit_for_bit(cuda_device, tracks, size):
    track, calls = tracks
    width, height, n, m = SIZES[size]
    cam, depths = room(width, height)
    cfg = config(n, m)
    launches = icp_gn.gn_system_packed.launches
    _, diags = run(cam, depths.to(cuda_device), cfg)
    torch.cuda.synchronize()
    shape = (1, n, m)  # both sizes are multiples of the packers' blocks
    assert track.captures == {shape: 1} and track.replays == {shape: STEPS - 1}
    (graph,) = odometry._GRAPHS.values()
    assert graph.tally == {(icp_gn.gn_system_packed, shape): cfg.icp_iterations}
    assert icp_gn.gn_system_packed.launches - launches == STEPS * cfg.icp_iterations
    assert any(bool(d.promoted) for d in diags)
    assert len(calls) == STEPS
    # The replays' outputs are compared only now, after every later replay.
    for step, (inputs, out) in enumerate(calls):
        eager = odometry._fused_gn(*inputs, cfg)
        for name, got, want in zip(("T", "num_corr", "fitness"), out, eager):
            assert torch.equal(got, want), f"step {step}: {name} differs from the eager loop's"


@pytest.mark.cuda
def test_cuda_changed_huber_delta_captures_a_second_graph(cuda_device, tracks):
    track, _ = tracks
    width, height, n, m = SIZES["1024x2048"]
    cam, depths = room(width, height, steps=3)
    depths = depths.to(cuda_device)
    cfg = config(n, m)
    run(cam, depths, cfg)
    run(cam, depths, dataclasses.replace(cfg, huber_delta=0.03))
    shape = (1, n, m)
    assert len(odometry._GRAPHS) == 2
    assert track.captures == {shape: 2} and track.replays == {shape: 4}


@pytest.mark.cuda
def test_cuda_replayed_outputs_are_not_overwritten(cuda_device, tracks):
    track, calls = tracks
    width, height, n, m = SIZES["1024x2048"]
    cam, depths = room(width, height, steps=7)
    depths = depths.to(cuda_device)
    cfg = config(n, m)
    state = init_state(cam, depths[0], cfg)
    state, _ = odometry_step(state, depths[1], cam, cfg)  # eager, then the capture
    state, diag = odometry_step(state, depths[2], cam, cfg)  # the first replay
    held = [state.pose, *diag, *calls[1][1]]
    kept = [t.clone() for t in held]
    for depth in depths[3:]:  # 5 more replays
        state, _ = odometry_step(state, depth, cam, cfg)
    assert track.replays == {(1, n, m): 6}
    for before, after in zip(kept, held):
        assert torch.equal(before, after)
