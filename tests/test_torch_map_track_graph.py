"""Map-mode odometry's hash solve replayed as a CUDA graph
(``models/slam/odometry._track_map``, ``_hash_solve``, ``_Graph``), the
map-mode twin of ``test_torch_track_graph.py``.

The eager path the graph is held to is ``eager_track_map`` below: the
hash and brute engines' solve written out as one loop (the source's cell
sort, ``icp_iterations`` updates, the stats query).

On the CPU: map mode never captures (``_track_map.captures`` and
``.replays`` stay empty, the graph cache too) and each step's (T,
num_corr, fitness, nn_overflow, src_mask) equals the eager path's, with
the hash engine and with brute NN; the graph key changes with the
function, the inputs' shapes and dtypes, the config's numbers and the
TF32 flags, and with nothing else.

On a CUDA card (marked ``cuda``, skipped without one), over 12 steps of
the room sweep with at least one promotion, at 1024 points against a
2048-point map (160x120) and 8192 against 32768 (640x480): each step's
outputs from the graph equal the eager path's from the same inputs, bit
for bit, also across the hash rebuilds between replays; one capture and
11 replays at the key, K3+K4 counted ``icp_iterations + 1`` times a
step; a replayed step's outputs are unchanged after 5 more replays; a
changed ``map_nn_radius`` captures a second graph. This file imports
neither jax nor the JAX package, so it runs on the card with ``python -m
pytest tests/test_torch_map_track_graph.py -q --noconftest -o addopts=``.
"""

import functools
from collections import Counter

import pytest
import torch

from perception_tpu_torch import _tensor
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.slam import odometry
from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
from perception_tpu_torch.ops import nn, voxelhash
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query
from perception_tpu_torch.ops.points import apply_mask
from test_torch_track_graph import STEPS, room, run

SIZES = {"1024x2048": (160, 120, 1024, 2048), "8192x32768": (640, 480, 8192, 32768)}


def config(point_budget, map_budget, map_nn="hash", **kw):
    return OdometryConfig(point_budget=point_budget, keyframe_budget=map_budget, map_budget=map_budget,
                          map_nn=map_nn, normal_max_edge=0.2, **kw)


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
def tracks(monkeypatch):
    """A fresh graph cache and counters; every ``_track_map`` call's
    inputs and outputs, in order."""
    track = odometry._track_map
    monkeypatch.setattr(odometry, "_GRAPHS", {})
    monkeypatch.setattr(track, "captures", Counter())
    monkeypatch.setattr(track, "replays", Counter())
    calls = []

    @functools.wraps(track)  # shares the counters, which the entry reaches through its own name
    def recorded(state, src_pts, src_mask, T0, cfg):
        out = track(state, src_pts, src_mask, T0, cfg)
        calls.append(((state, src_pts, src_mask, T0), out))
        return out

    monkeypatch.setattr(odometry, "_track_map", recorded)
    return track, calls


def assert_equals_eager(calls, cfg):
    for step, (inputs, out) in enumerate(calls):
        eager = eager_track_map(*inputs, cfg)
        for name, got, want in zip(("T", "num_corr", "fitness", "nn_overflow", "src_mask"), out, eager):
            assert torch.equal(got, want), f"step {step}: {name} differs from the eager path's"


@pytest.mark.parametrize("engine", ["hash", "brute"])
def test_cpu_never_captures(tracks, engine):
    track, calls = tracks
    cam, depths = room(64, 48, steps=3)
    cfg = config(256, 512, map_nn=engine, icp_iterations=4)
    _, diags = run(cam, depths, cfg)
    assert len(calls) == 3
    assert track.captures == Counter() and track.replays == Counter() and odometry._GRAPHS == {}
    assert_equals_eager(calls, cfg)
    assert all(int(d.num_corr) > 0 for d in diags)


def test_graph_key_holds_what_the_capture_depends_on():
    inputs = (torch.zeros(8, 3), torch.ones(8, dtype=torch.bool))
    key = odometry._graph_key(odometry._hash_solve, inputs, 10, 0.06)
    assert odometry._graph_key(odometry._hash_solve, tuple(torch.ones_like(t) for t in inputs), 10, 0.06) == key
    others = [odometry._graph_key(odometry._fused_gn, inputs, 10, 0.06),
              odometry._graph_key(odometry._hash_solve, (torch.zeros(16, 3), inputs[1]), 10, 0.06),
              odometry._graph_key(odometry._hash_solve, (inputs[0].double(), inputs[1]), 10, 0.06),
              odometry._graph_key(odometry._hash_solve, inputs, 10, 0.08),
              odometry._graph_key(odometry._hash_solve, inputs, 8, 0.06)]
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = not saved
        others.append(odometry._graph_key(odometry._hash_solve, inputs, 10, 0.06))
    finally:
        matmul.allow_tf32 = saved
    assert key not in others and len(set(others)) == len(others)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K3+K4 have no CPU mode")
    return torch.device("cuda", 0)


def k3_shape(n, state):
    """K3+K4's (padded queries, table rows) for ``n`` source points; the
    sizes here are multiples of every tile the query picks."""
    return (n, state.map_hash.table.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_cuda_graph_equals_eager_bit_for_bit(cuda_device, tracks, size):
    track, calls = tracks
    width, height, n, m = SIZES[size]
    cam, depths = room(width, height)
    cfg = config(n, m)
    launches = voxelhash_query.launches
    _, diags = run(cam, depths.to(cuda_device), cfg)
    torch.cuda.synchronize()
    shape = k3_shape(n, calls[0][0][0])
    assert track.captures == {shape: 1} and track.replays == {shape: STEPS - 1}
    (graph,) = odometry._GRAPHS.values()
    assert graph.tally == {(voxelhash_query, shape): cfg.icp_iterations + 1}
    assert voxelhash_query.launches - launches == STEPS * (cfg.icp_iterations + 1)
    assert any(bool(d.promoted) for d in diags[:-1]), "a replay must follow a hash rebuild"
    assert len(calls) == STEPS
    # The replays' outputs are compared only now, after every later replay.
    assert_equals_eager(calls, cfg)


@pytest.mark.cuda
def test_cuda_changed_radius_captures_a_second_graph(cuda_device, tracks):
    track, calls = tracks
    width, height, n, m = SIZES["1024x2048"]
    cam, depths = room(width, height, steps=3)
    depths = depths.to(cuda_device)
    cfg = config(n, m)
    run(cam, depths, cfg)
    run(cam, depths, config(n, m, map_nn_radius=0.08))
    shape = k3_shape(n, calls[0][0][0])
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
    assert track.replays == {k3_shape(n, calls[0][0][0]): 6}
    for before, after in zip(kept, held):
        assert torch.equal(before, after)
