"""The loops replayed as CUDA graphs through ``_graph.captured``:
keyframe mode's fused Gauss-Newton loop on K2 (``odometry._fused_gn``),
map mode's hash solve on K3+K4 (``odometry._hash_solve``) and the
cuboid's yaw-restart point-to-plane ICP (``cuboid._pose_p2plane``).

Each is held to its eager path: keyframe mode to ``_fused_gn`` on the
step's operands, map mode to ``eager_track_map`` below, the hash and
brute engines' solve written out as one loop (the source's cell sort,
``icp_iterations`` updates, the stats query), the cuboid to
``eager_cuboid_pose`` below (the yaw restarts, the ICP, the best
restart, written out).

On the CPU: CPU tensors never capture (``_graph.captures``,
``_graph.replays`` and the graph cache stay empty) and each step's
outputs equal the eager path's, in keyframe mode and in map mode with
the hash and brute engines; the graph key changes with the function, the
inputs' shapes and dtypes, every config field and the TF32 flags, and
not with tensor values; ``_tensor._filled``, the constant that ``const``
builds while a stream captures, equals ``torch.tensor``'s bit for bit
(-0.0, NaN, mixed rows, scalars); inside ``tallied`` ``count_launch``
counts into the block's tally alone, and counting a tally again (as a
replay does) adds it to the wrapper and the span. ``estimate_cuboid_pose``
on CPU tensors equals ``eager_cuboid_pose`` and captures nothing; the
point-to-plane mode goes through ``_graph.captured`` once a call and
``pcl_parity()`` (point-to-point) never; the cuboid's key changes with
every ``CuboidConfig`` field, ``icp_restarts`` among them.

On a CUDA card (marked ``cuda``, skipped without one), in keyframe mode
and on the hash, over 12 steps of the room sweep with a promotion before
the last step, at 1024 x 2048 (160x120) and 8192 x 32768 (640x480): each
step's outputs from the graph equal the eager path's from the same
inputs, bit for bit; one capture and 11 replays at the key, the kernel
counted ``icp_iterations`` (K2) or ``icp_iterations + 1`` (K3+K4) times
a step at the capture's shape; a changed ``huber_delta`` or
``map_nn_radius`` captures a second graph; a replayed step's outputs are
unchanged after 5 more replays. The cuboid's pose solve at the
configuration's sizes (1024-row box clouds, the 1280-row template), one
frame and B = 1, 8 and 64 over 4 calls with different box clouds: each
call's outputs equal ``eager_cuboid_pose``'s bit for bit, one capture
and 3 replays; a changed ``icp_restarts`` captures a second graph; a
replay's outputs are unchanged after 5 more replays. This file imports
neither jax nor the
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
from perception_tpu_torch.bench.scene import benchmark_template
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models import cuboid
from perception_tpu_torch.models.cuboid import CuboidConfig, estimate_cuboid_pose, template_features
from perception_tpu_torch.models.slam import odometry
from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
from perception_tpu_torch.ops import nn, voxelhash
from perception_tpu_torch.ops import points as P
from perception_tpu_torch.ops.icp import icp_point_to_plane
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
def graphs(monkeypatch):
    """A fresh graph cache and counters."""
    monkeypatch.setattr(_graph, "_GRAPHS", {})
    monkeypatch.setattr(_graph, "captures", Counter())
    monkeypatch.setattr(_graph, "replays", Counter())


@pytest.fixture
def calls(monkeypatch, graphs, mode):
    """A fresh graph cache and counters; every track call's inputs
    (state, src_pts, src_mask, T0) and outputs, in order."""
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


def changed(value):
    """Another value of a config field's type."""
    if isinstance(value, str):
        return value + "_"
    if isinstance(value, tuple):
        return tuple(v + 1 for v in value)
    return 1.0 if value is None else value + 1


def assert_key_holds(fn, other_fn, cfg):
    """The key of ``fn`` at ``cfg`` is that of any values of the same
    inputs and an equal config, and differs from that of another
    function, another shape, another dtype, any config field changed and
    either TF32 flag flipped, which all differ from each other."""
    inputs = (torch.zeros(8, 3), torch.ones(8, dtype=torch.bool))
    key = _graph._key(fn, inputs, cfg)
    assert _graph._key(fn, tuple(torch.ones_like(t) for t in inputs), dataclasses.replace(cfg)) == key
    others = [_graph._key(other_fn, inputs, cfg),
              _graph._key(fn, (torch.zeros(16, 3), inputs[1]), cfg),
              _graph._key(fn, (inputs[0].double(), inputs[1]), cfg)]
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        others.append(_graph._key(fn, inputs, dataclasses.replace(cfg, **{field.name: changed(value)})))
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        saved = flags.allow_tf32
        try:
            flags.allow_tf32 = not saved
            others.append(_graph._key(fn, inputs, cfg))
        finally:
            flags.allow_tf32 = saved
    assert key not in others and len(set(others)) == len(others)


def test_graph_key_holds_what_the_capture_depends_on():
    assert_key_holds(odometry._hash_solve, odometry._fused_gn, OdometryConfig())


def test_cuboid_graph_key_holds_what_the_capture_depends_on():
    cfg = CuboidConfig()
    assert_key_holds(cuboid._pose_p2plane, odometry._hash_solve, cfg)
    inputs = (torch.zeros(8, 3), torch.ones(8, dtype=torch.bool))
    assert (_graph._key(cuboid._pose_p2plane, inputs, dataclasses.replace(cfg, icp_restarts=8))
            != _graph._key(cuboid._pose_p2plane, inputs, cfg))


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


def cuboid_template(cfg, device):
    """The benchmark template prepared for ``cfg``: (points, mask, normals)."""
    tnp = benchmark_template()
    pts, nrm, mask = template_features(tnp, np.ones(len(tnp), bool), cfg, device=device)
    return pts, mask, nrm


def box_clouds(seed, batch, cfg, device):
    """Scene clouds at ``box_capacity`` rows: the benchmark template's
    points, each cloud under its own yaw and offset about 0.8 m ahead,
    1.5 mm of noise, a seeded share of its rows masked out, the masked
    rows at the sentinel. (points, mask): (B, N, 3) and (B, N), or one
    frame's (N, 3) and (N,) where ``batch`` is None."""
    rng = np.random.default_rng(seed)
    tnp = benchmark_template()
    n, frames = cfg.box_capacity, batch or 1
    pts = np.zeros((frames, n, 3), np.float32)
    mask = np.zeros((frames, n), bool)
    for f in range(frames):
        rows = rng.choice(len(tnp), size=min(n, len(tnp)), replace=False)
        yaw = rng.uniform(0.0, 2.0 * math.pi)
        c, s = math.cos(yaw), math.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), 0.8])
        cloud = tnp[rows] @ R.T + t + rng.normal(0.0, 0.0015, (len(rows), 3))
        pts[f, :len(rows)] = cloud
        mask[f, :len(rows)] = rng.random(len(rows)) < rng.uniform(0.5, 0.95)
    pts_t, mask_t = torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)
    pts_t = P.apply_mask(pts_t, mask_t)
    return (pts_t[0], mask_t[0]) if batch is None else (pts_t, mask_t)


def eager_cuboid_pose(box_points, box_mask, template, template_mask, template_normals, cfg):
    """The point-to-plane pose solve written out: the yaw restarts, the
    ICP of each, the restart of least fitness and its inverse."""
    k = cfg.icp_restarts
    inits = cuboid._yaw_restart_inits(P.centroid(box_points, box_mask), P.centroid(template, template_mask), k,
                                      box_points.dtype)
    lead = box_points.shape[:-2]
    res = icp_point_to_plane(box_points[..., None, :, :].expand(lead + (k,) + box_points.shape[-2:]),
                             box_mask[..., None, :].expand(lead + (k,) + box_mask.shape[-1:]),
                             template, template_normals, template_mask, inits,
                             max_iterations=cfg.icp_max_iterations, transformation_epsilon=1e-12)
    best = torch.argmin(res.fitness, dim=-1, keepdim=True)
    T = torch.take_along_dim(res.transform, best[..., None, None], dim=-3)[..., 0, :, :]
    return (se3.inverse(T), torch.take_along_dim(res.fitness, best, dim=-1)[..., 0],
            torch.take_along_dim(res.converged, best, dim=-1)[..., 0])


def cuboid_pose(clouds, tmpl, cfg):
    """``estimate_cuboid_pose`` of one call's clouds against the template."""
    pts, mask, nrm = tmpl
    return estimate_cuboid_pose(*clouds, pts, mask, cfg, template_normals=nrm)


def assert_cuboid_equals_eager(clouds, outs, tmpl, cfg):
    pts, mask, nrm = tmpl
    for call, (cloud, out) in enumerate(zip(clouds, outs)):
        want = eager_cuboid_pose(*cloud, pts, mask, nrm, cfg)
        assert len(out) == len(want) == 3
        for name, got, w in zip(("pose", "fitness", "converged"), out, want):
            assert torch.equal(got, w), f"call {call}: {name} differs from the eager path's"


CPU_CUBOID = CuboidConfig(box_capacity=256, icp_max_iterations=6)


@pytest.mark.parametrize("batch", [None, 2])
def test_cuboid_cpu_never_captures(graphs, batch):
    tmpl = cuboid_template(CPU_CUBOID, "cpu")
    clouds = [box_clouds(seed, batch, CPU_CUBOID, "cpu") for seed in range(3)]
    outs = [cuboid_pose(c, tmpl, CPU_CUBOID) for c in clouds]
    assert _graph.captures == Counter() and _graph.replays == Counter() and _graph._GRAPHS == {}
    assert_cuboid_equals_eager(clouds, outs, tmpl, CPU_CUBOID)
    assert all(bool((out[1] < 1e-4).all()) for out in outs)  # each cloud found: noise-level fitness


@pytest.mark.parametrize("name, cfg, through_graph", [
    ("p2plane", CPU_CUBOID, 1),
    ("pcl_parity", dataclasses.replace(CuboidConfig.pcl_parity(), box_capacity=256,
                                       icp_max_iterations=30), 0)])
def test_cuboid_route_follows_the_icp_mode(monkeypatch, graphs, name, cfg, through_graph):
    seen, real = [], _graph.captured

    def spy(fn, inputs, key_cfg):
        seen.append((fn, key_cfg))
        return real(fn, inputs, key_cfg)

    monkeypatch.setattr(_graph, "captured", spy)
    tmpl = cuboid_template(cfg, "cpu")
    out = cuboid_pose(box_clouds(0, 2, cfg, "cpu"), tmpl, cfg)
    assert len(seen) == through_graph and all(fn is cuboid._pose_p2plane and c == cfg for fn, c in seen)
    assert out[0].shape == (2, 4, 4) and bool(torch.isfinite(out[0]).all())


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


CUBOID_CALLS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 1, 8, 64])
def test_cuda_cuboid_graph_equals_eager_bit_for_bit(cuda_device, graphs, batch):
    cfg = CuboidConfig()
    tmpl = cuboid_template(cfg, cuda_device)
    clouds = [box_clouds(seed, batch, cfg, cuda_device) for seed in range(CUBOID_CALLS)]
    outs = [cuboid_pose(c, tmpl, cfg) for c in clouds]
    torch.cuda.synchronize()
    assert _graph.captures == {"_pose_p2plane": 1} and _graph.replays == {"_pose_p2plane": CUBOID_CALLS - 1}
    (graph,) = _graph._GRAPHS.values()
    assert graph.tally == {}  # no counted kernel: the ICP is ATen's and cuBLAS's
    # The replays' outputs are compared only now, after every later replay.
    assert_cuboid_equals_eager(clouds, outs, tmpl, cfg)
    assert all(bool((out[1] < 1e-4).all()) for out in outs)


@pytest.mark.cuda
def test_cuda_cuboid_changed_config_captures_a_second_graph(cuda_device, graphs):
    cfg = CuboidConfig()
    tmpl = cuboid_template(cfg, cuda_device)
    clouds = [box_clouds(seed, 8, cfg, cuda_device) for seed in range(3)]
    for c in (cfg, dataclasses.replace(cfg, icp_restarts=8)):
        outs = [cuboid_pose(cloud, tmpl, c) for cloud in clouds]
        assert_cuboid_equals_eager(clouds, outs, tmpl, c)
    assert len(_graph._GRAPHS) == 2
    assert _graph.captures == {"_pose_p2plane": 2} and _graph.replays == {"_pose_p2plane": 4}


@pytest.mark.cuda
def test_cuda_cuboid_replayed_outputs_are_not_overwritten(cuda_device, graphs):
    cfg = CuboidConfig()
    tmpl = cuboid_template(cfg, cuda_device)
    clouds = [box_clouds(seed, 8, cfg, cuda_device) for seed in range(7)]
    cuboid_pose(clouds[0], tmpl, cfg)  # eager, then the capture
    held = cuboid_pose(clouds[1], tmpl, cfg)  # the first replay
    kept = [t.clone() for t in held]
    for cloud in clouds[2:]:  # 5 more replays
        cuboid_pose(cloud, tmpl, cfg)
    assert _graph.replays == {"_pose_p2plane": 6}
    for before, after in zip(kept, held):
        assert torch.equal(before, after)
