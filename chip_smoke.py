"""Smoke run of perception_tpu_torch on one CUDA card.

Builds the port's three kernels from ``perception_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and holds each against its
plain PyTorch version at the shapes its path gives it: K1, fused RANSAC
scoring, bit-exact (B=1 and 8 at N=8192 for the cuboid, 32768 for the
detection service, 24576 for the tracker, and K=1023, B=3 edges; random
points, and points exactly at +-tau, one ulp past it, -0.0, NaN and +-inf,
valid and masked), its launch plan printed and held to at least 8 warps
an SM at the four path shapes; K2, the fused Gauss-Newton ICP system,
with equal gate counts and M within rtol/atol 1e-4; K3+K4, the voxel-hash query,
bit-exact below and above 49152 table rows. Then drives the port's
paths through their entry points, each with the kernels' launch counts
set to 0 just before it and read just after:

- the cuboid pipeline at 640x480 on the 8 bench frames, through
  ``cuboid_pipeline_from_depth`` (one frame at a time) and
  ``cuboid_pipeline_batch`` (B=8): acceptance, pose against ground truth,
  one K1 launch per RANSAC call, and the card against the port's CPU path;
- SLAM odometry at 640x480 through ``run_odometry`` over 40 frames of the
  textured-room sweep, under four configurations (keyframe mode with the
  op graph and with K2; map mode at map_budget 32768 with the shortlist
  and with the voxel hash): ATE, overlap, exact launch counts, and the
  card against the port's CPU path over the first 5 frames;
- the keyframe SLAM system at 640x480 through ``run_slam`` over all 300
  frames of the sweep (``benchmarks/slam_bench.py``'s settings), with BA
  and without on K2, and in map mode at map_budget 32768 on the voxel
  hash: ATE, live loop closures, BA runs that never raise their cost,
  exact launch counts; the card against the port's CPU path over the
  first 12 frames (same RANSAC triplets); ``slam_step``'s host syncs,
  from torch's sync debug mode, held to the reads it states; a
  stage-timed pass (odometry, features, matching, RANSAC+PnP, BA, pose
  graph) and timed passes (frames/s, ms per tracking / promotion frame);
- the cuboid pipeline's other modes on the 8 bench frames at B=8:
  ``cluster_filter="cc"`` and ``icp_mode="p2p"`` (acceptance, pose against
  ground truth, the card against the CPU), and ``CuboidConfig.pcl_parity()``
  on the first frames, timed;
- the detection service through ``detect_object`` in
  ``benchmarks/objects_bench.py``'s setting (the 640x480 clutter scene, the
  four captured class templates and a plate that matches nothing): success
  and chamfer error per class, the plate rejected, the card against the
  CPU on the same triplets, the host syncs held to the stated count, ms
  per call;
- the streaming tracker through ``track_step_from_depth`` in
  ``benchmarks/tracking_bench.py``'s setting (300 frames at 640x480, three
  cuboids): frames/s, median and p90 error, latched and warm shares,
  gated; the card against the CPU over the first frames; one host read of
  ``steady`` a frame;
- the pose and hand path of the CNN facade, which runs none of the three
  kernels (its CNN is cuDNN, its decode PyTorch): the repo's trained tiny
  MPI_15 PoseNet through ``extract_people`` on 8 seeded scenes at 128x128
  in one batch (PCK and recall equal to the CPU's and at the JAX
  package's gate of 0.75 and 0.9), the trained hand net on 8 noisy hand
  scenes (mean landmark error under 3 px in 7 of 8), and the facade's
  pose -> hand chain on one frame, each on the card against the CPU and
  with no host sync; ``PoseNet()`` at full width (BODY_25, 3 stages) at
  368x368 (``benchmarks/pose_bench.py``'s setting) with seeded weights:
  maps and the decode of the card's maps on the card against the CPU, one
  480x640 frame through the antialiased downsample; ``extract_people`` ms
  a frame at B=1 and B=8, the CNN alone against its bound (f32 operations
  at 67 TFLOP/s), ``resize_and_merge`` and ``nms_heatmap`` at the
  reference's stage shapes, the decode's stages, the device busy share.

Each kernel is timed at its path's shapes against its plain version, in
turns (plain, kernel, kernel, plain): the kernel's eager wrapper call by
CUDA events, and its device time by replaying a CUDA graph of its
wrapper's calls (without the wrapper's host cost); beside them its
bound, the least time the card could take for the same work (f32
operations at 67 TFLOP/s or bytes at 3.35 TB/s, whichever is longer;
K3+K4's work is read from the timed call's chunk counts), and the share
of that bound; for K1 also its issue-rate floor, 8 instructions a pair
(3 multiplies, 3 adds, the compare, the count; no FMA) at 128 lanes an
SM a clock at ``nvidia-smi``'s ``clocks.max.sm``. ``kernel_times.py``
times the same calls alone. In the SLAM phase, torch.profiler over the
first frames of keyframe+BA K2 and map 32768 hash gives the device busy
share and K2's and K3+K4's device time per frame.

Prints the card, each check and the times, the run's wall time; then a
JSON line of the kernels; and last ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, when there is no card or any check fails.

Run from the repository root: ``python3 chip_smoke.py``
"""

from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FRAMES = 8
K1_TIMED = ((1, 8192), (8, 8192), (1, 32768), (1, 24576))  # the path shapes (B, N) at K=1024
KERNEL_SHAPES = [  # (B, N, K, inputs): "random", "edges" (k1_edge_inputs) or "all masked"
    *((b, n, 1024, inputs) for b, n in K1_TIMED for inputs in ("random", "edges")),
    *((b, n, k, inputs) for b, n, k in ((1, 777, 100), (3, 777, 100), (1, 8192, 1023))
      for inputs in ("random", "edges")),
    (1, 8192, 1024, "all masked"),
]
K1_MIN_WARPS_PER_SM = 8  # what K1's launch plan must give each path shape
K1_INSTRUCTIONS = 8      # a pair: 3 multiplies, 3 adds, the compare, the count (no FMA)
TAU = 0.015
KERNELS = ("ransac_score", "icp_gn", "voxelhash_query")
K2_SHAPES = [  # (R, N, M, all source points masked); the first three are odometry's
    (1, 4096, 8192, False),    # default OdometryConfig
    (1, 2048, 4096, False),    # the SLAM bench's keyframe mode
    (1, 8192, 32768, False),   # benchmarks/odometry_bench.py's large shape
    (3, 217, 100, False),      # unaligned
    (1, 4096, 8192, True),
]
K2_TOL = dict(rtol=1e-4, atol=1e-4)  # float sums in another order
K3_CASES = [  # (map points, queries, query order, all map points masked)
    (32768, 2048, "sorted", False),   # Npad 33792: the odometry hash at map_budget 32768
    (32768, 4096, "sorted", False),
    (65536, 4096, "sorted", False),   # Npad 66560: past 49152 rows (K4's regime on the TPU)
    (32768, 2048, "caller", False),   # incoherent order: tiles overflow
    (32768, 2048, "sorted", True),
]
ODO_FRAMES = 40
CPU_FRAMES = 5
SLAM_FRAMES = 300        # the SLAM bench's sweep_trajectory(n=300)
SLAM_CPU_FRAMES = 12     # card against CPU: two promotions, each with a BA run
SLAM_PASSES = 1          # timed passes per SLAM configuration: one keeps the run well inside its limit
PROFILE_FRAMES = 30      # slam_step calls under torch.profiler (keyframe+BA K2, map hash)
OBJ_CLASSES = ("eraser", "screwdriver", "clamp", "marker")
OBJ_TIMED_CALLS = 3      # timed detect_object calls per class, after a warm-up
OBJ_CPU_CLASSES = ("eraser", "marker")  # card against CPU: the CPU takes 10-120 s a call
# The JAX package's answers in this setting (objects_reference.py, on the
# CPU): (success, winning cluster, size difference, chamfer cm). Its
# size-based winner takes another class's cluster for the screwdriver,
# clamp and marker, so only the eraser is found where it lies; the card
# must give the same answers, chamfer within 0.05 cm of the reference's.
OBJ_JAX_REFERENCE = {
    "eraser": (True, 3, 73, 0.094),
    "screwdriver": (True, 2, 4, 14.986),
    "clamp": (True, 1, 26, 23.764),
    "marker": (True, 3, 40, 23.358),
}
TRACK_FRAMES = 300       # tracking_bench.py's camera_trajectory(300)
TRACK_CPU_FRAMES = 6     # tracker on the card against the CPU
TRACK_SYNC_FRAMES = 4    # tracker steps under torch's sync debug mode
PARITY_FRAMES = 2        # bench frames through CuboidConfig.pcl_parity()
# The JAX package's translation errors in mm on the 8 bench frames under
# CuboidConfig(icp_mode="p2p") (20 iterations), on the CPU with its own
# triplets; tests/test_torch_objects.py holds the port to them. Point-to-
# point ICP has not converged in 20 iterations on frames 3 and 5-7, so the
# p2p gate is 2 cm or, where the reference misses that, its error + 1 mm.
P2P_JAX_ERROR_MM = (6.40, 7.60, 4.51, 11.68, 5.63, 18.64, 27.48, 19.82)
POSE_SEED = 1234         # the fixture scenes: the first POSE_SCENES of numpy's default_rng(POSE_SEED)
POSE_SCENES = 8
# The JAX package's (PCK, recall) on those scenes (pck_on_images on the
# CPU; tests/test_torch_pose.py holds the port and the JAX package to
# them). Both are above the JAX package's gate of 0.75 and 0.9.
POSE_JAX_PCK = (0.7911111111111111, 1.0)
HAND_SEED = 11           # the hand scenes: the first HAND_SCENES of default_rng(HAND_SEED)
HAND_SCENES = 8
POSE_KP_TOL = 1e-3       # px: keypoints on the card against the CPU on the same maps or weights
POSE_SCORE_TOL = 1e-4    # person scores (mean limb scores), likewise
HAND_TOL = 1e-3          # px: hand landmarks, card against CPU
CHAIN_TOL = 1e-2         # px: pose -> hand landmarks, card against CPU (boxes move with the keypoints)
WIDE_MAP_RTOL = 1e-4     # full-width maps, card against CPU: max abs diff over the maps' max magnitude
WIDE_HW = (368, 368)     # pose_bench.py's net resolution, the reference's own
WIDE_BATCH = 8           # pose_bench.py's batch
TIMED_REPS = 3           # timed runs (median, with the spread), each of TIMED_CALLS calls after a warm-up
TIMED_CALLS = 5
PEAK_F32_OPS = 67e12     # H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def require(ok, message):
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def kernel_inputs(b, n, k, all_masked, device, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, n, 3) * 0.1).astype(np.float32)
    mask = np.zeros((b, n), bool) if all_masked else rng.rand(b, n) > 0.2
    normals = rng.randn(b, k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    d = (rng.randn(b, k, 1) * 0.05).astype(np.float32)
    hyp = np.concatenate([normals, d], axis=-1)
    return tuple(torch.from_numpy(a).to(device) for a in (pts, mask, hyp))


def k1_edge_inputs(b, n, k, device, seed=0):
    """K1 inputs that a scan can get wrong, on top of ``kernel_inputs``:
    planes x = 0, y = 0 (normal -y), z = tau and z = -tau (normal -z,
    zeros -0.0), every 8th hypothesis each; points exactly at distance
    +-tau from them (x or y = +-tau, z = 0, -0.0 or 2 tau), one ulp past
    tau, with a -0.0 coordinate, or with a NaN or +-inf coordinate,
    about 1/8 of the points each, masked or not as ``kernel_inputs``
    draws."""
    pts, mask, hyp = (t.numpy().copy() for t in kernel_inputs(b, n, k, False, "cpu", seed))
    rng = np.random.RandomState(seed + 1)
    tau = np.float32(TAU)
    hyp[:, 0::8] = [1, 0, 0, 0]
    hyp[:, 1::8] = [0, -1, 0, 0]
    hyp[:, 2::8] = [0, 0, 1, -tau]
    hyp[:, 3::8] = [-0.0, -0.0, -1, tau]
    kind = rng.randint(0, 8, (b, n))
    sign = np.where(rng.rand(b, n) < 0.5, np.float32(-1), np.float32(1))
    axis = rng.randint(0, 3, (b, n))
    special = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), (b, n))
    sel = {j: kind == j for j in range(6)}
    pts[..., 0] = np.where(sel[0], sign * tau, pts[..., 0])
    pts[..., 1] = np.where(sel[1], sign * tau, pts[..., 1])
    pts[..., 2] = np.where(sel[2], np.where(sign > 0, 2 * tau, np.float32(-0.0)), pts[..., 2])
    pts[..., 0] = np.where(sel[3], sign * np.nextafter(tau, np.float32(1)), pts[..., 0])
    for c in range(3):
        pts[..., c] = np.where(sel[4] & (axis == c), np.float32(-0.0), pts[..., c])
        pts[..., c] = np.where(sel[5] & (axis == c), special, pts[..., c])
    return tuple(torch.from_numpy(a).to(device) for a in (pts, mask, hyp))


def k1_inputs(b, n, k, inputs, device, seed=0):
    if inputs == "edges":
        return k1_edge_inputs(b, n, k, device, seed)
    return kernel_inputs(b, n, k, inputs == "all masked", device, seed)


def cuda_ms(fn, iters):
    """Mean time of ``fn()`` on the card in ms, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(ops, nbytes):
    """The least time in ms for ``ops`` f32 operations (every multiply, add
    and compare one; the kernels forbid FMA contraction) and ``nbytes``
    moved, and which of the two sets it."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def graph_ms(fn, calls=20, replays=10):
    """Device time of one ``fn()`` in ms: a CUDA graph of ``calls`` calls,
    replayed ``replays`` times between CUDA events (no host cost)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def profile_launches(fn, calls=20):
    """{kernel: mean device us per launch} over ``calls`` eager calls, by
    torch.profiler (a process that profiled before may drop events, so
    only per-launch means are kept)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"[a-z][a-z_]*_kernel", e.name)
            name = m.group(0) if m else e.name[:40]
            total[name] = total.get(name, 0.0) + (e.time_range.end - e.time_range.start)
            count[name] = count.get(name, 0) + 1
    return {name: total[name] / count[name] for name in total}


def timed(label, kernel, plain, work, plain_iters=10):
    """Time ``kernel`` against ``plain`` in turns (plain, kernel, kernel,
    plain), each by CUDA events: the kernel's eager wrapper call (``ms``,
    as every earlier run timed it) and, beside it, its device time by
    CUDA-graph replay (``device_ms``, without the wrapper's host cost);
    then its kernels' device time per launch (torch.profiler) and its
    bound from ``work()`` -> (operations, bytes), read after the timing
    window. Prints them and returns a dict of the numbers."""
    runs = [cuda_ms(plain, plain_iters), (cuda_ms(kernel, 100), graph_ms(kernel)),
            (cuda_ms(kernel, 100), graph_ms(kernel)), cuda_ms(plain, plain_iters)]
    ops, moved = work()
    b_ms, b_by = bound(ops, moved)
    ms, device = min(runs[1][0], runs[2][0]), min(runs[1][1], runs[2][1])
    print(f"time {label}: eager call {runs[1][0]:.4f} / {runs[2][0]:.4f} ms, device "
          f"{runs[1][1]:.4f} / {runs[2][1]:.4f} ms (graph replay), plain {runs[0]:.4f} / {runs[3]:.4f} ms; "
          f"bound {b_ms:.5f} ms ({b_by}: {ops:.3e} ops, {moved:.3e} bytes), share of bound "
          f"{b_ms / ms:.3f} (eager) / {b_ms / device:.3f} (device)")
    per = {k: round(v, 3) for k, v in profile_launches(kernel).items()}
    print(f"  device us per launch by kernel (torch.profiler, 20 eager calls): {per}")
    return dict(ms=ms, device_ms=device, plain_ms=min(runs[0], runs[3]), bound_ms=b_ms, bound_by=b_by)


def check_kernel(device):
    """K1 against its plain version at every shape and input, one launch a
    call; its launch plan at the path shapes, printed and held to at
    least K1_MIN_WARPS_PER_SM warps an SM. Returns max |diff|."""
    from perception_tpu_torch.ops.kernels.build import sm_count
    from perception_tpu_torch.ops.kernels.ransac_score import launch_plan, ransac_score, ransac_score_reference

    sms = sm_count(device.index)
    for b, n in K1_TIMED:
        plan = launch_plan(b, n, 1024, sms)
        print(f"K1 launch plan at B={b} N={n} K=1024 on {sms} SMs: {plan}")
        require(plan.warps_per_sm >= K1_MIN_WARPS_PER_SM,
                f"K1 launches under {K1_MIN_WARPS_PER_SM} warps an SM at {(b, n)}")
    worst = 0
    for b, n, k, inputs in KERNEL_SHAPES:
        pts, mask, hyp = k1_inputs(b, n, k, inputs, device)
        before = ransac_score.launches
        got = ransac_score(pts, mask, hyp, TAU)
        torch.cuda.synchronize()
        want = ransac_score_reference(pts, mask, hyp, TAU)
        diff = int((got - want).abs().max())
        print(f"K1 ransac_score B={b} N={n} K={k} {inputs}: equal={torch.equal(got, want)} "
              f"max_abs_err={diff} inliers={int(want.sum())}")
        require(ransac_score.launches == before + 1, "K1: not one launch a call")
        require(torch.equal(got, want), f"kernel != plain version at {(b, n, k, inputs)}")
        require(inputs != "all masked" or int(got.abs().sum()) == 0, "all-masked counts not zero")
        worst = max(worst, diff)
    return worst


def max_sm_clock_hz():
    """The card's highest SM clock, ``nvidia-smi --query-gpu=clocks.max.sm``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def k1_floor_ms(b, n, k, sms, clock_hz):
    """K1's issue-rate floor: K1_INSTRUCTIONS a pair at 128 lanes an SM a clock."""
    return b * n * k * K1_INSTRUCTIONS / (sms * 128 * clock_hz) * 1e3


def time_kernel(device):
    """K1 and its plain version at the paths' shapes (the cuboid at B=1 and
    B=8, the detection service, the tracker), in ms, with the issue-rate
    floor beside the bound."""
    from perception_tpu_torch.ops.kernels.build import sm_count
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score, ransac_score_reference

    clock = max_sm_clock_hz()
    times = {}
    for b, n in K1_TIMED:
        pts, mask, hyp = kernel_inputs(b, n, 1024, False, device, seed=1)
        # 3 multiplies, 3 adds, the compare with tau, the mask and the count a pair.
        times[(b, n)] = timed(f"K1 ransac_score (B={b}, N={n}, K=1024)",
                              lambda: ransac_score(pts, mask, hyp, TAU),
                              lambda: ransac_score_reference(pts, mask, hyp, TAU),
                              lambda: (9 * b * n * 1024, nbytes(pts, mask, hyp) + 4 * b * 1024),
                              plain_iters=20)
        floor = k1_floor_ms(b, n, 1024, sm_count(device.index), clock)
        times[(b, n)]["floor_ms"] = floor
        print(f"  K1 issue-rate floor at {clock / 1e6:.0f} MHz: {floor:.5f} ms, device share of floor "
              f"{floor / times[(b, n)]['device_ms']:.3f}")
    return times


def check_k2(device):
    """K2 against its plain version at every shape; returns max |diff| of M and stats."""
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed, gn_system_reference

    worst = 0.0
    for r, n, m, all_masked in K2_SHAPES:
        args = k2_inputs(r, n, m, all_masked, device)
        M, st = gn_system_packed(*args, 0.25, 0.02, return_stats=True)
        torch.cuda.synchronize()
        Mr, sr = gn_system_reference(*args, 0.25, 0.02)
        err = max(float((M - Mr).abs().max()), float((st - sr).abs().max()))
        gates_equal = torch.equal(st[:, 0], sr[:, 0])
        close = torch.allclose(M, Mr, **K2_TOL) and torch.allclose(st[:, 1], sr[:, 1], **K2_TOL)
        print(f"K2 icp_gn R={r} N={n} M={m} all_masked={all_masked}: gates equal {gates_equal} "
              f"({int(sr[:, 0].sum())}), M and gated d2 within rtol/atol 1e-4 {close}, max_abs_err {err:.3e}")
        require(gates_equal and close, f"K2 != plain version at {(r, n, m, all_masked)}")
        require(not all_masked or not M.any(), "all-masked K2 system not zero")
        worst = max(worst, err)
    return worst


def k2_inputs(r, n, m, all_masked, device, seed=0):
    """Packed operands of a posed random problem, and the poses."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.ops.kernels.icp_gn import pack_source, pack_target

    rng = np.random.RandomState(seed)
    src = torch.from_numpy((rng.randn(r, n, 3) * 0.3).astype(np.float32))
    smask = torch.from_numpy(np.zeros((r, n), bool) if all_masked else rng.rand(r, n) > 0.1)
    tgt = torch.from_numpy((rng.randn(m, 3) * 0.3).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.from_numpy(rng.randn(m, 3).astype(np.float32)), dim=1)
    tmask = torch.from_numpy(rng.rand(m) > 0.1)
    xi = torch.from_numpy((rng.randn(r, 6) * 0.02).astype(np.float32))
    src8 = pack_source(src, smask).to(device)
    tgtd, tn = (t.to(device) for t in pack_target(tgt, nrm, tmask))
    return src8, tgtd, tn, se3.se3_exp(xi).to(device)


def time_k2(device):
    """K2 and its plain version at odometry's shapes (plain, kernel, kernel, plain), with its
    launch plan (at least 2 blocks per SM) and bound."""
    from perception_tpu_torch.ops.kernels.build import sm_count
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed, gn_system_reference, launch_plan

    times = {}
    for r, n, m, _ in K2_SHAPES[:3]:
        args = k2_inputs(r, n, m, False, device, seed=1)
        src8, tgtd = args[0], args[1]
        R, Np, Mp = src8.shape[0], src8.shape[1], tgtd.shape[0]
        plan = launch_plan(R, Np, Mp, sm_count(device.index))
        print(f"K2 launch plan at R={R} Np={Np} Mp={Mp}: {plan}")
        require(plan.blocks >= 2 * sm_count(device.index), f"K2 launches under 2 blocks per SM at {(n, m)}")
        # 10 operations a (source, target) pair (3 multiplies and 3 adds for
        # p.t - |t|^2/2, the doubling, the subtraction, the compare, the
        # select) and about 130 a source point (transform, residual, weight,
        # the 44 products of w Jhat^T Jhat, the sums).
        times[(n, m)] = timed(f"K2 icp_gn (R={r}, N={n}, M={m})",
                              lambda: gn_system_packed(*args, 0.25, 0.02, return_stats=True),
                              lambda: gn_system_reference(*args, 0.25, 0.02),
                              lambda: (R * Np * (10 * Mp + 130), nbytes(*args) + 4 * R * 66))
    return times


def room_surface(n, seed):
    """n points on the five planes of the textured room, as a fused map holds them."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(-1.0, 1.0, (n, 2))
    plane = rng.randint(0, 5, n)
    pts = np.empty((n, 3))
    for k, (axis, c, (a, b), (sa, sb)) in enumerate([
        (1, 0.9, (0, 2), (1.3, 1.5)), (1, -0.9, (0, 2), (1.3, 1.5)), (2, 3.0, (0, 1), (1.3, 0.9)),
        (0, 1.3, (1, 2), (0.9, 1.5)), (0, -1.3, (1, 2), (0.9, 1.5)),
    ]):
        sel = plane == k
        pts[sel, axis] = c
        pts[sel, a] = u[sel, 0] * sa
        pts[sel, b] = u[sel, 1] * sb + (1.5 if b == 2 else 0.0)
    return pts.astype(np.float32)


def k3_case(m, nq, order, all_masked, device, seed=0):
    """A hash of an m-point room map and the kernel's arguments for nq
    noisy queries in ``order`` ("sorted": cell order; "caller": as drawn)."""
    from perception_tpu_torch.ops import voxelhash

    rng = np.random.RandomState(seed)
    ref = room_surface(m, seed)
    q = ref[rng.randint(0, m, nq)] + (rng.randn(nq, 3) * 0.01).astype(np.float32)
    mask = np.zeros(m, bool) if all_masked else np.ones(m, bool)
    vh = voxelhash.build(torch.from_numpy(ref).to(device), torch.from_numpy(mask).to(device), 0.06)
    q = torch.from_numpy(q).to(device)
    if order == "sorted":
        q, _ = voxelhash.sort_by_cell(vh, q)
    return voxelhash.kernel_args(vh, q)


def check_k3(device):
    """K3+K4 against its plain version: torch.equal on idx and d2; returns max |diff| of d2."""
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query, voxelhash_query_reference

    worst = 0.0
    for m, nq, order, all_masked in K3_CASES:
        args, overflow = k3_case(m, nq, order, all_masked, device)
        idx, d2 = voxelhash_query(*args)
        torch.cuda.synchronize()
        ridx, rd2 = voxelhash_query_reference(*args)
        equal = torch.equal(idx, ridx) and torch.equal(d2, rd2)
        table, _, _, nchunk, tile = args[:5]
        print(f"K3+K4 voxelhash_query map={m} (Npad {table.shape[0]}) queries={nq} {order} "
              f"all_masked={all_masked}: equal {equal}, tile {tile}, chunks max {int(nchunk.max())}, "
              f"overflow {float(overflow):.3f}, found {float((rd2[:nq] <= 0.06 ** 2).float().mean()):.3f}")
        require(equal, f"K3+K4 != plain version at {(m, nq, order, all_masked)}")
        require(order == "sorted" or float(overflow) > 0, "unsorted queries did not overflow any tile")
        require(not all_masked or float(rd2[:nq].min()) > 1e11, "all-masked table found a neighbour")
        worst = max(worst, float((d2 - rd2).abs().max()))
    return worst


def time_k3(device):
    """K3+K4 and its plain version at the hash's shapes (plain, kernel, kernel, plain), with
    its launch plan (at least 2 blocks per SM) and bound."""
    from perception_tpu_torch.ops.kernels.build import sm_count
    from perception_tpu_torch.ops.kernels.voxelhash_query import (
        launch_plan,
        voxelhash_query,
        voxelhash_query_reference,
    )

    times = {}
    for m, nq in ((32768, 2048), (65536, 4096)):
        args, _ = k3_case(m, nq, "sorted", False, device, seed=1)
        table, queries, start, nchunk, tile, R, rblk = args
        plan = launch_plan(queries.shape[0], tile, R, rblk, sm_count(device.index))
        print(f"K3+K4 launch plan at {queries.shape[0]} queries, tile {tile}, R {R}, rblk {rblk}: {plan}")
        require(plan.blocks >= 2 * sm_count(device.index), f"K3+K4 launches under 2 blocks per SM at {(m, nq)}")
        live = {}

        def work():
            # Read after the timing window from the timed call's chunk counts:
            # the rows each tile's range holds, 9 operations a (query, row)
            # pair (3 subtracts, 3 multiplies, 2 adds, the compare).
            rows = torch.minimum(torch.clamp(nchunk.long() * rblk, max=R), table.shape[0] - start.long())
            live.update(pairs=int(rows.sum()) * tile, pieces=int(torch.ceil(rows / plan.piece_rows).sum()))
            return 9 * live["pairs"], nbytes(table, queries, start, nchunk) + 8 * queries.shape[0]

        times[(m, nq)] = timed(f"K3+K4 voxelhash_query (map {m}, {nq} sorted queries)",
                               lambda: voxelhash_query(*args), lambda: voxelhash_query_reference(*args), work)
        print(f"  K3+K4 work: {live['pairs']} pairs, live pieces {live['pieces']} of {plan.blocks} blocks")
    return times


def translation_errors(res, gts):
    return np.linalg.norm(res.pose[..., :3, 3].cpu().numpy() - gts[:, :3, 3], axis=-1)


def run_slice(device):
    """Drive the main path on the card and check it; returns its results."""
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_batch,
        cuboid_pipeline_from_depth,
        decimate,
        ransac_input,
        template_features,
    )
    from perception_tpu_torch.ops.ransac import _sample_indices

    cfg = CuboidConfig()
    camera = PinholeCamera.d435_depth()
    tnp = benchmark_template()
    depths_np, gts = bench_frames(camera, range(FRAMES))
    depths_cpu = torch.from_numpy(depths_np)
    state = {}
    for dev in ("cpu", device):
        t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=dev)
        state[dev] = dict(template=t, template_mask=tm, template_normals=tn)
    depths = depths_cpu.to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def one(i):
        return cuboid_pipeline_from_depth(depths[i], camera, generator=gen, config=cfg, **state[device])

    def batch():
        return cuboid_pipeline_batch(depths, camera, generator=gen, config=cfg, **state[device])

    # The path, counted: 8 single-frame calls, then one call at B=8.
    reset_launches()
    singles = [one(i) for i in range(FRAMES)]
    torch.cuda.synchronize()
    counts = read_launches()
    reset_launches()
    batched = batch()
    torch.cuda.synchronize()
    batch_counts = read_launches()
    launches = (counts["ransac_score"], batch_counts["ransac_score"])
    print(f"cuboid path: {FRAMES} x cuboid_pipeline_from_depth: launches {counts}; "
          f"1 x cuboid_pipeline_batch(B={FRAMES}): launches {batch_counts}")
    require(counts == {"ransac_score": FRAMES, "icp_gn": 0, "voxelhash_query": 0}
            and batch_counts == {"ransac_score": 1, "icp_gn": 0, "voxelhash_query": 0},
            "expected one K1 launch per RANSAC call and no other kernel")

    stacked = type(batched)(*(torch.stack(t) for t in zip(*singles)))
    for name, res in (("B=1", stacked), (f"B={FRAMES}", batched)):
        err = translation_errors(res, gts)
        fit = res.fitness.cpu().numpy()
        acc = res.accepted.cpu().numpy()
        print(f"{name}: accepted {acc.tolist()} fitness max {fit.max():.3e} "
              f"translation error mm {np.round(err * 1e3, 2).tolist()}")
        require(acc.all(), f"{name}: not every frame accepted")
        require(np.all(err <= 0.02), f"{name}: translation error over 2 cm")
        require(all(torch.isfinite(t).all() for t in res if t.is_floating_point()),
                f"{name}: non-finite output")
        require(res.pose.shape == (FRAMES, 4, 4) and res.bbox.shape == (FRAMES, 8, 3),
                f"{name}: wrong output shapes")

    # The card against the port's CPU path, with the same RANSAC triplets.
    d, cam2 = decimate(depths_cpu, camera, cfg.depth_stride)
    _, dm = ransac_input(*cam2.backproject_depth(d), cfg)
    idx = _sample_indices(torch.Generator().manual_seed(7), dm, cfg.ransac_hypotheses)
    res = {dev: cuboid_pipeline_batch(depths_cpu.to(dev), camera, config=cfg, indices=idx, **state[dev])
           for dev in ("cpu", device)}
    c, g = res["cpu"], type(res[device])(*(t.cpu() for t in res[device]))
    dt = np.linalg.norm((c.pose[:, :3, 3] - g.pose[:, :3, 3]).numpy(), axis=-1)
    rel = np.abs(g.fitness.numpy() / c.fitness.numpy() - 1)
    print(f"cuda vs cpu (same triplets): accepted equal {torch.equal(c.accepted, g.accepted)}, "
          f"translation diff max {dt.max() * 1e3:.4f} mm, fitness rel diff max {rel.max():.2e}, "
          f"num_box_points cpu {c.num_box_points.tolist()} cuda {g.num_box_points.tolist()}")
    require(torch.equal(c.accepted, g.accepted), "CUDA and CPU accept different frames")
    require(np.all(dt <= 1e-3), "CUDA and CPU poses differ by more than 1 mm")
    require(bool((c.fitness < cfg.fitness_threshold).all() and (g.fitness < cfg.fitness_threshold).all()),
            "fitness over the gate")
    require(np.all(rel <= 5e-2), "CUDA and CPU fitness differ by more than rtol 5e-2")
    return launches, one, batch


def wrappers():
    """Every kernel's wrapper, by kernel name; each counts its launches."""
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query

    return {"ransac_score": ransac_score, "icp_gn": gn_system_packed, "voxelhash_query": voxelhash_query}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0


def read_launches():
    return {name: w.launches for name, w in wrappers().items()}


def slam_scene(frames=SLAM_FRAMES):
    """The SLAM bench's 640x480 camera and the textured room along
    ``sweep_trajectory(n=300)``, its first ``frames`` poses rendered once
    (frames in parallel; seed = frame index): (camera, gt (frames, 4, 4),
    grays, depths (frames, H, W))."""
    from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
    from perception_tpu_torch.geometry.camera import PinholeCamera

    w, h = 640, 480
    fx = 307.0 * w / 320.0
    camera = PinholeCamera.from_K([fx, 0, w / 2, 0, fx, h / 2, 0, 0, 1], width=w, height=h)
    gt = sweep_trajectory(n=SLAM_FRAMES)[:frames]
    with ThreadPoolExecutor(8) as pool:
        images = list(pool.map(lambda i: render_textured_room(camera, gt[i], seed=i), range(frames)))
    grays = np.stack([g for g, _ in images])
    depths = np.stack([d for _, d in images])
    return camera, np.stack(gt), grays, depths


# benchmarks/slam_bench.py's odometry settings.
BENCH_ODOM = dict(point_budget=2048, keyframe_budget=4096, icp_iterations=8, min_depth=0.1,
                  max_depth=6.0, normal_max_edge=0.1, kf_translation=0.10, kf_rotation=0.12)


def odometry_configs():
    """The default keyframe mode (op graph, then K2) and the SLAM bench's
    map-fusion settings (benchmarks/slam_bench.py) at map_budget 32768
    (shortlist, then the voxel hash)."""
    from perception_tpu_torch.models.slam.odometry import OdometryConfig

    return {
        "keyframe fused_gn=auto": OdometryConfig(fused_gn="auto"),
        "keyframe fused_gn=on": OdometryConfig(fused_gn="on"),
        "map 32768 map_nn=auto": OdometryConfig(**BENCH_ODOM, map_budget=32768, map_nn="auto"),
        "map 32768 map_nn=hash": OdometryConfig(**BENCH_ODOM, map_budget=32768, map_nn="hash"),
    }


def expected_launches(cfg, steps):
    """K2 runs once per GN iteration under fused_gn="on" (keyframe mode);
    the hash query once per iteration and once for the final stats."""
    return {
        "ransac_score": 0,
        "icp_gn": steps * cfg.icp_iterations if cfg.map_budget == 0 and cfg.fused_gn == "on" else 0,
        "voxelhash_query": steps * (cfg.icp_iterations + 1) if cfg.map_budget > 0 and cfg.map_nn == "hash" else 0,
    }


def run_odometry_paths(device, scene):
    """Drive run_odometry at 640x480 over the scene's first ODO_FRAMES
    frames under the four configurations and check each; returns (kernel
    launches of the counted runs, frames/s)."""
    from perception_tpu_torch.models.slam.odometry import run_odometry
    from perception_tpu_torch.utils.metrics import ate

    camera, gt, _, depths_np = scene
    gt, depths_np = gt[:ODO_FRAMES], depths_np[:ODO_FRAMES]
    depths = torch.from_numpy(depths_np).to(device)
    launches, rates = {}, {}
    for name, cfg in odometry_configs().items():
        # The path, counted.
        reset_launches()
        poses, diags = run_odometry(camera, depths, cfg)
        torch.cuda.synchronize()
        counts = read_launches()
        want = expected_launches(cfg, ODO_FRAMES - 1)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        est = torch.stack(poses).cpu()
        res = ate(est.numpy().astype(np.float64), gt, align=False)
        overlap = torch.stack([d.overlap for d in diags]).cpu()
        overflow = float(torch.stack([d.nn_overflow for d in diags]).max())
        keyframes = 1 + int(torch.stack([d.promoted for d in diags]).sum())
        print(f"odometry [{name}]: ATE rmse {res.rmse * 100:.3f} cm (max {res.max * 100:.3f}), "
              f"min overlap {float(overlap.min()):.4f}, max nn_overflow {overflow:.4f}, "
              f"keyframes {keyframes}, launches {counts}")
        require(counts == want, f"{name}: kernel launches {counts}, expected {want}")
        require(est.shape == (ODO_FRAMES, 4, 4) and bool(torch.isfinite(est).all()), f"{name}: bad poses")
        require(res.rmse <= 0.02, f"{name}: ATE over 2 cm")
        require(float(overlap.min()) > 0.5, f"{name}: overlap at or under 0.5")

        # The card against the port's CPU path over the first frames.
        if cfg.fused_gn == "on" or cfg.map_nn == "hash":
            cpu_poses, _ = run_odometry(camera, torch.from_numpy(depths_np[:CPU_FRAMES]), cfg)
            cpu = torch.stack(cpu_poses)
            dt = float((cpu[:, :3, 3] - est[:CPU_FRAMES, :3, 3]).norm(dim=-1).max())
            dr = float((cpu[:, :3, :3] - est[:CPU_FRAMES, :3, :3]).abs().max())
            print(f"odometry [{name}] cuda vs cpu, first {CPU_FRAMES} frames: translation diff max "
                  f"{dt * 1e3:.6f} mm, rotation entry diff max {dr:.3e}")
            require(dt <= 1e-3, f"{name}: CUDA and CPU poses differ by more than 1 mm")

        fps, runs = frames_per_s(lambda: run_odometry(camera, depths, cfg), ODO_FRAMES)
        rates[name] = fps
        print(f"odometry [{name}]: {fps:.2f} frames/s (passes {[round(r, 2) for r in runs]})")
    return launches, rates


def frames_per_s(fn, frames, passes=3):
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(frames / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def slam_configs():
    """benchmarks/slam_bench.py's three configurations, with the engine
    named: keyframe mode with BA and without (the bench's ablation), each
    on K2, and map fusion at map_budget 32768 on the voxel hash."""
    from perception_tpu_torch.models.slam.odometry import OdometryConfig
    from perception_tpu_torch.models.slam.system import SlamConfig

    slam = dict(max_keyframes=64, max_edges=192, features_per_kf=256, fast_threshold=15.0,
                lc_min_gap=3, lc_min_matches=20, lc_min_inliers=10)
    k2 = OdometryConfig(**BENCH_ODOM, fused_gn="on")
    return {
        "slam keyframe+BA K2": SlamConfig(odometry=k2, **slam),
        "slam keyframe no-BA K2": SlamConfig(odometry=k2, enable_ba=False, **slam),
        "slam map 32768 hash": SlamConfig(
            odometry=OdometryConfig(**BENCH_ODOM, map_budget=32768, map_nn="hash"), **slam),
    }


def slam_summary(state, diags):
    """The SLAM bench's counts (benchmarks/slam_bench.py) and the BA costs."""
    def stack(field):
        return torch.stack([getattr(d, field) for d in diags]).cpu()

    ba = stack("ba_ran")
    return {
        "keyframes": int(state.keyframes.count),
        "loop_closures": int(((state.edges.weight == 2.0) & state.edges.mask).sum()),
        "ba_runs": int(ba.sum()),
        "landmarks": int(state.landmarks.mask.sum()),
        "observations": int(state.obs.mask.sum()),
        "promoted": stack("promoted").numpy(),
        "ba_ran": ba.numpy(),
        "ba_cost0": stack("ba_cost0").numpy(),
        "ba_cost1": stack("ba_cost1").numpy(),
    }


def slam_pass(camera, depths, grays, cfg, step=None):
    """One timed pass of the slam_step loop over frames already on the
    card: (frames/s over the 299 steps as the SLAM bench counts them, ms
    of each step, promoted flags). Each step reads ``promoted`` anyway, so
    the synchronize after it costs little."""
    from perception_tpu_torch.models.slam import system

    step = step or system.slam_step
    state = system.slam_init(camera, depths[0], grays[0], cfg)
    gen = torch.Generator(device=depths.device).manual_seed(0)
    torch.cuda.synchronize()
    ms, promoted = [], []
    t0 = time.perf_counter()
    for i in range(1, len(depths)):
        t = time.perf_counter()
        state, diag = step(state, depths[i], grays[i], camera, gen, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        promoted.append(bool(diag.promoted))
    fps = (len(depths) - 1) / (time.perf_counter() - t0)
    return fps, np.array(ms), np.array(promoted)


STAGES = {  # stage -> the system module's names it times
    "odometry": ("odometry_step",),
    "features": ("_kf_features",),
    "matching": ("match_descriptors",),
    "ransac+pnp": ("_draw_triplets", "ransac_rigid", "pnp_gn"),
    "ba": ("bundle_adjust",),
    "pose graph": ("optimize_pose_graph",),
}


def slam_stage_times(camera, depths, grays, cfg):
    """One pass with a synchronize around each stage: median ms per stage
    over tracking frames and over promotion frames."""
    from perception_tpu_torch.models.slam import system

    stages = {stage: [(system, n) for n in names] for stage, names in STAGES.items()}
    rows = []

    def step(*args):
        out = []
        rows.append(stage_ms(lambda: out.append(system.slam_step(*args)), stages))
        return out[0]

    _, _, promoted = slam_pass(camera, depths, grays, cfg, step=step)
    keys = list(STAGES) + ["rest", "step"]
    out = {}
    for kind, sel in (("tracking", ~promoted), ("promotion", promoted)):
        out[kind] = {k: float(np.median([r.get(k, 0.0) for r, p in zip(rows, sel) if p])) for k in keys}
    return out


def host_syncs(camera, depths, grays, cfg, frames):
    """The host syncs of slam_step over the first frames, from torch's sync
    debug mode: one (kind, Counter of "file:line") per step, kind
    "tracking" or "promotion"."""
    from perception_tpu_torch.models.slam import system

    state = system.slam_init(camera, depths[0], grays[0], cfg)
    gen = torch.Generator(device=depths.device).manual_seed(0)
    torch.cuda.synchronize()
    steps = []
    for i in range(1, frames):
        with recorded_syncs() as sites:
            state, diag = system.slam_step(state, depths[i], grays[i], camera, gen, cfg)
        steps.append(("promotion" if bool(diag.promoted) else "tracking", sites))
    return steps


@contextlib.contextmanager
def recorded_syncs():
    """The host syncs inside the block, from torch's sync debug mode: a
    Counter of "file:line" (paths under the package relative to it; a sync
    inside torch's Python code is named with the port's line that got
    there, "torch/...:n via ops/...:m")."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            where = filename.split("site-packages/")[-1].split("perception_tpu_torch/")[-1]
            site = f"{where}:{lineno}"
            if where.startswith("torch/"):  # name the port's line that got there
                port = [f for f in traceback.extract_stack() if "/perception_tpu_torch/" in f.filename]
                if port:
                    site += f" via {port[-1].filename.split('perception_tpu_torch/')[-1]}:{port[-1].lineno}"
            sites[site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def check_host_syncs(name, cfg, steps):
    """Print the syncs per kind of frame and hold them to slam_step's
    contract: its own reads (``_read_flag`` in system.py) are 1 on a
    tracking frame and 1 + ``loop_ok`` + ``do_ba`` on a promotion frame;
    odometry reads ``promote`` once a frame in map mode; the rigid fit's
    ``torch.linalg.svd`` syncs inside the library on promotion frames; a
    sync in torch/cuda/__init__.py is CUDA's lazy initialisation."""
    import collections

    for kind in ("tracking", "promotion"):
        total = collections.Counter()
        for k, sites in steps:
            if k == kind:
                total.update(sites)
        n = sum(k == kind for k, _ in steps)
        print(f"{name} host syncs (torch sync debug mode), {n} {kind} frames: "
              f"{sum(total.values()) / max(n, 1):.2f} per frame, by line {dict(total)}")
    own_promotion = 1 + int(cfg.correct_in_step) + int(cfg.enable_ba)
    for kind, sites in steps:
        by_file = collections.Counter()
        for site, count in sites.items():
            by_file[site.split(" via ")[0].rsplit(":", 1)[0]] += count
        require(by_file.pop("models/slam/system.py", 0) == (1 if kind == "tracking" else own_promotion),
                f"{name}: slam_step's own host reads on a {kind} frame are not as stated")
        require(by_file.pop("models/slam/odometry.py", 0) == int(cfg.odometry.map_budget > 0),
                f"{name}: odometry's host reads are not one a frame in map mode and none otherwise")
        require(kind == "promotion" or "ops/registration.py" not in by_file,
                f"{name}: the rigid fit ran on a tracking frame")
        by_file.pop("ops/registration.py", None)
        by_file.pop("torch/cuda/__init__.py", None)
        require(not by_file, f"{name}: host syncs at {dict(by_file)}")


def slam_profile(camera, depths, grays, cfg, frames=PROFILE_FRAMES):
    """torch.profiler over slam_step on the first ``frames`` frames: the
    device busy share (device time of all kernels, copies and sets over
    the wall time, which the profiler inflates) and ms of device time per
    step of K2's and K3+K4's kernels."""
    from perception_tpu_torch.models.slam import system

    state = [system.slam_init(camera, depths[0], grays[0], cfg)]
    gen = torch.Generator(device=depths.device).manual_seed(0)
    index = iter(range(1, frames))

    def step():
        i = next(index)
        state[0], _ = system.slam_step(state[0], depths[i], grays[i], camera, gen, cfg)

    busy, wall, by_name, ops = device_profile(step, frames - 1)
    ours = {key: sum(ms for name, ms in by_name.items() if mark in name)
            for key, mark in (("icp_gn", "icp_gn_"), ("voxelhash_query", "voxelhash_"))}
    return {"busy": busy, "device_ops": ops, "wall_ms_per_step": wall,
            **{f"{k}_ms_per_step": v for k, v in ours.items()}}


def run_slam_paths(device, scene):
    """Drive the keyframe SLAM system (run_slam) at 640x480 over the
    300-frame sweep under the three configurations and check each; returns
    the kernel launches of the counted runs."""
    from perception_tpu_torch.models.slam import system
    from perception_tpu_torch.ops.ransac import _sample_indices
    from perception_tpu_torch.utils.metrics import ate

    camera, gt, grays_np, depths_np = scene
    depths = torch.from_numpy(depths_np).to(device)
    grays = torch.from_numpy(grays_np).to(device)
    launches = {}
    for n_cfg, (name, cfg) in enumerate(slam_configs().items()):
        # The path, counted.
        reset_launches()
        t0 = time.perf_counter()
        state, poses, diags = system.run_slam(camera, depths, grays, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_launches()
        want = expected_launches(cfg.odometry, SLAM_FRAMES - 1)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        est = torch.stack(poses).cpu()
        res = ate(est.numpy().astype(np.float64), gt, align=False)
        s = slam_summary(state, diags)
        ran = s["ba_ran"]
        print(f"{name}: ATE rmse {res.rmse * 100:.3f} cm (max {res.max * 100:.3f}), keyframes {s['keyframes']}, "
              f"loop closures {s['loop_closures']}, BA runs {s['ba_runs']}, landmarks {s['landmarks']}, "
              f"observations {s['observations']}, launches {counts}, counted run {first_s:.1f} s")
        if s["ba_runs"]:
            print(f"{name}: BA cost px^2 before/after, median {np.median(s['ba_cost0'][ran]):.4f} / "
                  f"{np.median(s['ba_cost1'][ran]):.4f}, worst after-before "
                  f"{float((s['ba_cost1'][ran] - s['ba_cost0'][ran]).max()):.3e}")
        require(counts == want, f"{name}: kernel launches {counts}, expected {want}")
        require(est.shape == (SLAM_FRAMES, 4, 4) and bool(torch.isfinite(est).all()), f"{name}: bad poses")
        require(res.rmse <= 0.02, f"{name}: ATE over 2 cm")
        require(s["loop_closures"] >= 1, f"{name}: no live loop-closure edge")
        if cfg.enable_ba:
            require(s["ba_runs"] >= 1, f"{name}: BA never ran")
            require(bool(np.all(s["ba_cost1"][ran] <= s["ba_cost0"][ran])), f"{name}: a BA run raised its cost")
        else:
            require(s["ba_runs"] == 0, f"{name}: BA ran with enable_ba=False")

        if n_cfg == 0:
            # The card against the port's CPU path, with the same RANSAC triplets.
            first = np.flatnonzero(s["promoted"][:SLAM_CPU_FRAMES - 1]) + 1
            first_ba = np.flatnonzero(s["ba_ran"][:SLAM_CPU_FRAMES - 1]) + 1
            require(len(first) and len(first_ba), f"no promotion with BA in the first {SLAM_CPU_FRAMES} frames")
            saved = system._draw_triplets
            runs = {}
            try:
                for dev in (device, "cpu"):
                    draws = iter(range(1000))
                    system._draw_triplets = lambda g, m, k: _sample_indices(  # noqa: E731
                        torch.Generator().manual_seed(next(draws)), m.cpu(), k).to(m.device)
                    n = SLAM_CPU_FRAMES
                    _, p, _ = system.run_slam(camera, depths[:n].to(dev), grays[:n].to(dev), cfg)
                    runs[str(dev)] = torch.stack(p).cpu()
            finally:
                system._draw_triplets = saved
            g, c = runs[str(device)], runs["cpu"]
            dt = float((g[:, :3, 3] - c[:, :3, 3]).norm(dim=-1).max())
            dr = float((g[:, :3, :3] - c[:, :3, :3]).abs().max())
            print(f"{name} cuda vs cpu, first {SLAM_CPU_FRAMES} frames (promotions at frames {first.tolist()}, "
                  f"BA at {first_ba.tolist()}): translation diff max {dt * 1e3:.6f} mm, "
                  f"rotation entry diff max {dr:.3e}")
            require(dt <= 1e-3, f"{name}: CUDA and CPU poses differ by more than 1 mm")

            stages = slam_stage_times(camera, depths, grays, cfg)
            for kind, row in stages.items():
                print(f"{name} stage ms ({kind} frame, median, synchronized): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in row.items()))

        check_host_syncs(name, cfg, host_syncs(camera, depths, grays, cfg, SLAM_CPU_FRAMES))

        if name != "slam keyframe no-BA K2":
            prof = slam_profile(camera, depths, grays, cfg)
            busy = f"{prof['busy']:.4f}" if prof["device_ops"] else "not measured (no device events)"
            print(f"{name} profile, {PROFILE_FRAMES - 1} steps (torch.profiler): device busy share {busy}, "
                  f"{prof['device_ops']} device ops, wall {prof['wall_ms_per_step']:.2f} ms a step, "
                  f"K2 {prof['icp_gn_ms_per_step']:.4f} ms and K3+K4 "
                  f"{prof['voxelhash_query_ms_per_step']:.4f} ms of device time a step")

        rates, ms, promoted = [], [], []
        for _ in range(SLAM_PASSES):
            fps, frame_ms, prom = slam_pass(camera, depths, grays, cfg)
            rates.append(fps)
            ms.append(frame_ms)
            promoted.append(prom)
        ms, promoted = np.concatenate(ms), np.concatenate(promoted)
        print(f"{name}: {statistics.median(rates):.2f} frames/s (passes {[round(r, 2) for r in rates]}), "
              f"median ms tracking frame {np.median(ms[~promoted]):.2f}, promotion frame "
              f"{np.median(ms[promoted]):.2f} ({int(promoted.sum()) // SLAM_PASSES} promotions a pass)")
    return launches


def device_profile(fn, calls):
    """torch.profiler over ``calls`` calls of ``fn``: (busy share = device
    time of every kernel, copy and set over the wall time, which the
    profiler inflates; wall ms a call; {device op name: ms a call}; the
    number of device ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, ops, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            busy += us
            ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    return busy / wall_us, wall_us / 1e3 / calls, {k: v / 1e3 / calls for k, v in by_name.items()}, ops


def top_ms(by_name, n=5):
    """The ``n`` device ops with the most time, names cut to 60 characters."""
    return {k[:60]: round(v, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]}


def stage_ms(fn, stages):
    """One call of ``fn`` with a synchronize around each stage: {label: ms},
    plus "rest" and "step" (the whole call); ``stages`` maps a label to
    the (module, function name) pairs of functions the call goes through."""
    acc, saved = {}, {}

    def timed_stage(real, label):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            acc[label] = acc.get(label, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    for label, functions in stages.items():
        for module, name in functions:
            saved[(module, name)] = getattr(module, name)
            setattr(module, name, timed_stage(saved[(module, name)], label))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    finally:
        for (module, name), real in saved.items():
            setattr(module, name, real)
    acc["step"] = (time.perf_counter() - t) * 1e3
    acc["rest"] = acc["step"] - sum(v for k, v in acc.items() if k != "step")
    return {k: round(v, 2) for k, v in acc.items()}


def source_line(module, text):
    """The line number of the one line of ``module`` holding ``text``."""
    import inspect

    hits = [i + 1 for i, line in enumerate(inspect.getsourcelines(module)[0]) if text in line]
    require(len(hits) == 1, f"{module.__name__}: {len(hits)} lines hold {text!r}")
    return hits[0]


@contextlib.contextmanager
def counted_calls(module, name):
    """Count the calls of ``module.name`` inside the block: yields a list
    whose length is the count."""
    calls, real = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def require_syncs(label, sites, want):
    """Hold a Counter of sync sites to ``want`` ("file:line" -> count); a
    sync in torch/cuda/__init__.py is CUDA's lazy initialisation."""
    got = {k: v for k, v in sites.items() if not k.startswith("torch/cuda/__init__.py")}
    print(f"{label} host syncs (torch sync debug mode): {dict(got)}; stated {want}")
    require(got == {k: v for k, v in want.items() if v}, f"{label}: host syncs {dict(got)}, stated {want}")


def chamfer_cm(template, est, gt):
    """Mean distance in cm from the template under the estimated pose to the
    template under the true pose (symmetry-safe pose error)."""
    from scipy.spatial import cKDTree

    a = template @ est[:3, :3].T + est[:3, 3]
    b = template @ gt[:3, :3].T + gt[:3, 3]
    return float(cKDTree(b).query(a)[0].mean() * 100.0)


def run_objects(device):
    """benchmarks/objects_bench.py's setting through ``detect_object``: the
    full D435 camera at 640x480, the clutter scene at seed 3,
    ObjectConfig(cluster_min_size=40, size_gate=250), the four captured
    class templates and a 0.3 x 0.3 x 0.02 m plate that matches no object.
    Returns the K1 launches of the counted calls."""
    from perception_tpu_torch.bench.clutter_scene import captured_template, render_depth_clutter, standard_clutter_poses
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.io.templates import box_surface_template
    from perception_tpu_torch.models.objects import ObjectConfig, detect_object, working_set
    from perception_tpu_torch.ops import icp, ransac
    from perception_tpu_torch.ops.ransac import _sample_indices

    camera = PinholeCamera.d435_depth()
    poses = standard_clutter_poses()
    pts_cpu, mask_cpu = camera.backproject_depth(torch.from_numpy(render_depth_clutter(camera, poses, seed=3)))
    templates = {name: captured_template(name, camera) for name in OBJ_CLASSES}
    templates["plate"] = box_surface_template((0.3, 0.3, 0.02), 0.003)
    cfg = ObjectConfig(cluster_min_size=40, size_gate=250)
    pts, mask = pts_cpu.to(device), mask_cpu.to(device)
    on_card = {name: (torch.from_numpy(t).to(device), torch.ones(len(t), dtype=torch.bool, device=device))
               for name, t in templates.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    print(f"objects scene: {camera.width}x{camera.height}, {int(mask_cpu.sum())} valid points, template points "
          f"{ {name: len(t) for name, t in templates.items()} }")

    # The path, counted: one call per template.
    reset_launches()
    results = {name: detect_object(pts, mask, *on_card[name], gen, cfg) for name in templates}
    torch.cuda.synchronize()
    counts = read_launches()
    print(f"objects path: {len(templates)} x detect_object: launches {counts}")
    require(counts == {"ransac_score": len(templates), "icp_gn": 0, "voxelhash_query": 0},
            f"expected {len(templates)} K1 launches (one per call) and no other kernel")
    for name, res in results.items():
        r = type(res)(*(t.cpu() for t in res))
        require(all(bool(torch.isfinite(t).all()) for t in r if t.is_floating_point() and t is not r.fitness),
                f"objects {name}: non-finite output")
        line = (f"objects [{name}]: success {bool(r.success)}, cluster {int(r.cluster_id)}, size diff "
                f"{int(r.size_diff)}, clusters {int(r.num_clusters)} sizes {r.cluster_sizes.tolist()}, "
                f"fitness {float(r.fitness):.3e}")
        if name == "plate":
            print(line)
            require(not bool(r.success) and int(r.cluster_id) == -1, "objects: the plate was not rejected")
            continue
        err = chamfer_cm(templates[name], r.pose.numpy().astype(np.float64), poses[name])
        success, cluster, diff, ref_err = OBJ_JAX_REFERENCE[name]
        print(f"{line}, chamfer {err:.3f} cm (JAX package: cluster {cluster}, size diff {diff}, chamfer {ref_err} cm)")
        require((bool(r.success), int(r.cluster_id), int(r.size_diff)) == (success, cluster, diff),
                f"objects {name}: the answer differs from the JAX package's")
        require(abs(err - ref_err) <= 0.05 and (ref_err >= 1.0 or err < 1.0),
                f"objects {name}: chamfer {err:.3f} cm against the JAX package's {ref_err} cm")

    # The card against the port's CPU path, with the same RANSAC triplets.
    _, dm, _ = working_set(pts_cpu, mask_cpu, cfg)
    idx = _sample_indices(torch.Generator().manual_seed(11), dm, cfg.ransac_hypotheses)
    for name in OBJ_CPU_CLASSES:
        t0 = time.perf_counter()
        c = detect_object(pts_cpu, mask_cpu, torch.from_numpy(templates[name]),
                          torch.ones(len(templates[name]), dtype=torch.bool), None, cfg, indices=idx)
        cpu_s = time.perf_counter() - t0
        g = detect_object(pts, mask, *on_card[name], None, cfg, indices=idx)
        g = type(g)(*(t.cpu() for t in g))
        dt = float((c.pose[:3, 3] - g.pose[:3, 3]).norm())
        same = all(torch.equal(getattr(c, f), getattr(g, f))
                   for f in ("success", "cluster_id", "cluster_sizes", "size_diff", "num_clusters"))
        print(f"objects [{name}] cuda vs cpu (same triplets): success, cluster, sizes, size diff equal {same}, "
              f"translation diff {dt * 1e3:.6f} mm (cpu call {cpu_s:.1f} s)")
        require(same, f"objects {name}: CUDA and CPU disagree")
        require(dt <= 1e-3, f"objects {name}: CUDA and CPU poses differ by more than 1 mm")

    # Host syncs of one call: 2 in each ICP trip's batched SVD, the ICP's
    # done.all() read every DONE_CHECK_EVERY trips, 1 in the plane refit's eigh.
    svd = f"ops/icp.py:{source_line(icp, 'torch.linalg.svd(')}"
    done = f"ops/icp.py:{source_line(icp, 'bool(done.all())')}"
    eigh = f"ops/ransac.py:{source_line(ransac, 'torch.linalg.eigh(')}"
    for name in ("eraser", "clamp"):
        torch.cuda.synchronize()
        with counted_calls(icp, "_umeyama") as trips, recorded_syncs() as sites:
            detect_object(pts, mask, *on_card[name], gen, cfg)
        n = len(trips)
        reads = len([k for k in range(icp.DONE_CHECK_EVERY, n + 1, icp.DONE_CHECK_EVERY)
                     if k < cfg.icp_max_iterations])
        print(f"objects [{name}]: {n} ICP trips of {cfg.icp_max_iterations}")
        require_syncs(f"objects [{name}]", sites, {svd: 2 * n, done: reads, eigh: 1})

    # ms per call per class: median of OBJ_TIMED_CALLS after a warm-up.
    for name in templates:
        runs = []
        detect_object(pts, mask, *on_card[name], gen, cfg)
        torch.cuda.synchronize()
        for _ in range(OBJ_TIMED_CALLS):
            t0 = time.perf_counter()
            detect_object(pts, mask, *on_card[name], gen, cfg)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        print(f"objects [{name}]: {statistics.median(runs):.2f} ms per call (calls {[round(r, 2) for r in runs]})")
    from perception_tpu_torch.models import objects

    for name in ("eraser", "clamp"):
        print(f"objects [{name}] stage ms (synchronized): " + str(stage_ms(
            lambda: detect_object(pts, mask, *on_card[name], gen, cfg),
            {"front end": [(objects, "front_end")], "icp": [(objects, "icp_batched")]})))
    busy, wall, by_name, _ = device_profile(lambda: detect_object(pts, mask, *on_card["eraser"], gen, cfg), 2)
    print(f"objects [eraser] profile (torch.profiler, 2 calls): device busy share {busy:.4f}, wall {wall:.2f} ms "
          f"a call, top device ms a call {top_ms(by_name)}")
    return counts["ransac_score"]


def run_cuboid_modes(device):
    """The 8 bench frames through the cuboid pipeline (B=8) with
    ``cluster_filter="cc"`` and with ``icp_mode="p2p"`` at the default
    iterations: all accepted within 2 cm, one K1 launch a call, the card
    against the CPU on the same triplets; then ``pcl_parity()`` on the
    first frames, timed. Returns the K1 launches of the counted calls."""
    import dataclasses

    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_batch,
        decimate,
        ransac_input,
        template_features,
    )
    from perception_tpu_torch.ops.ransac import _sample_indices

    camera = PinholeCamera.d435_depth()
    tnp = benchmark_template()
    depths_np, gts = bench_frames(camera, range(FRAMES))
    depths_cpu = torch.from_numpy(depths_np)
    depths = depths_cpu.to(device)
    launches = 0
    for name, cfg in (("cc", CuboidConfig(cluster_filter="cc")), ("p2p", CuboidConfig(icp_mode="p2p"))):
        state = {}
        for dev in ("cpu", device):
            t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=dev)
            state[str(dev)] = dict(template=t, template_mask=tm, template_normals=tn)
        gen = torch.Generator(device=device).manual_seed(0)
        reset_launches()
        res = cuboid_pipeline_batch(depths, camera, generator=gen, config=cfg, **state[str(device)])
        torch.cuda.synchronize()
        counts = read_launches()
        launches += counts["ransac_score"]
        err = translation_errors(res, gts)
        acc = res.accepted.cpu().numpy()
        print(f"cuboid [{name}] B={FRAMES}: accepted {acc.tolist()}, translation error mm "
              f"{np.round(err * 1e3, 2).tolist()}, launches {counts}")
        require(counts == {"ransac_score": 1, "icp_gn": 0, "voxelhash_query": 0}, f"cuboid {name}: launches {counts}")
        limit = 0.02 if name == "cc" else np.maximum(0.02, np.array(P2P_JAX_ERROR_MM) * 1e-3 + 1e-3)
        require(acc.all() and np.all(err <= limit), f"cuboid {name}: not 8/8 accepted within {limit} m")
        require(all(bool(torch.isfinite(t).all()) for t in res if t.is_floating_point()), f"cuboid {name}: non-finite")

        d, cam2 = decimate(depths_cpu, camera, cfg.depth_stride)
        _, dm = ransac_input(*cam2.backproject_depth(d), cfg)
        idx = _sample_indices(torch.Generator().manual_seed(7), dm, cfg.ransac_hypotheses)
        c = cuboid_pipeline_batch(depths_cpu, camera, config=cfg, indices=idx, **state["cpu"])
        g = cuboid_pipeline_batch(depths, camera, config=cfg, indices=idx, **state[str(device)])
        g = type(g)(*(t.cpu() for t in g))
        dt = np.linalg.norm((c.pose[:, :3, 3] - g.pose[:, :3, 3]).numpy(), axis=-1)
        print(f"cuboid [{name}] cuda vs cpu (same triplets): accepted equal {torch.equal(c.accepted, g.accepted)}, "
              f"translation diff max {dt.max() * 1e3:.4f} mm")
        require(torch.equal(c.accepted, g.accepted) and np.all(dt <= 1e-3), f"cuboid {name}: CUDA and CPU disagree")
        fps, runs = frames_per_s(
            lambda: cuboid_pipeline_batch(depths, camera, generator=gen, config=cfg, **state[str(device)]), FRAMES)
        print(f"cuboid [{name}] B={FRAMES}: {fps:.2f} frames/s (passes {[round(r, 2) for r in runs]})")

    cfg = CuboidConfig.pcl_parity()
    t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    sub = depths[:PARITY_FRAMES]
    cuboid_pipeline_batch(sub, camera, t, tm, gen, dataclasses.replace(cfg, icp_max_iterations=1), template_normals=tn)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = cuboid_pipeline_batch(sub, camera, t, tm, gen, cfg, template_normals=tn)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches()
    launches += counts["ransac_score"]
    err = translation_errors(res, gts[:PARITY_FRAMES])
    print(f"cuboid [pcl_parity] B={PARITY_FRAMES}: {ms:.1f} ms, accepted {res.accepted.tolist()}, fitness "
          f"{res.fitness.tolist()}, translation error mm {np.round(err * 1e3, 2).tolist()}, launches {counts}")
    require(counts["ransac_score"] == 1, "cuboid pcl_parity: not one K1 launch")
    require(all(bool(torch.isfinite(x).all()) for x in res if x.is_floating_point()), "cuboid pcl_parity: non-finite")
    return launches


def tracking_scene():
    """tracking_bench.py's scene: the 640x480 camera at fx 384, the three
    cuboids of CUBOID_SET with their templates (density 6 mm), and the
    300-frame camera_trajectory rendered once (frames in parallel, seed =
    frame index): (camera, templates (3, Nt, 3), masks, depths, gts)."""
    from perception_tpu_torch.bench.tracking_scene import CUBOID_SET, camera_trajectory, render_depth_cuboids
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.io.templates import cuboid_template

    w, h = 640, 480
    fx = 384.0 * w / 640.0
    camera = PinholeCamera.from_K([fx, 0, w / 2, 0, fx, h / 2, 0, 0, 1], width=w, height=h)
    tmpls = [cuboid_template(*dims, density=0.006) for dims, _ in CUBOID_SET]
    nt = max(len(t) for t in tmpls)
    templates, tmasks = np.zeros((len(tmpls), nt, 3), np.float32), np.zeros((len(tmpls), nt), bool)
    for k, t in enumerate(tmpls):
        templates[k, :len(t)], tmasks[k, :len(t)] = t, True
    traj = camera_trajectory(TRACK_FRAMES)
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(lambda i: render_depth_cuboids(camera, traj[i], seed=i), range(TRACK_FRAMES)))
    return camera, templates, tmasks, np.stack([d for d, _ in frames]), np.stack([np.stack(g) for _, g in frames])


def tracking_config():
    """tracking_bench.py's TrackingConfig."""
    from perception_tpu_torch.models.object_tracking import TrackingConfig
    from perception_tpu_torch.models.objects import ObjectConfig

    det = ObjectConfig(table_z_cut=0.9, z_limits=(0.0, 0.9), x_limits=(-0.35, 0.35), voxel_size=0.005,
                       cluster_min_size=40, cluster_capacity=1024, offplane_capacity=2048, work_capacity=24576)
    return TrackingConfig(detection=det, max_tracks=3, warm_icp_iterations=24)


def run_tracker(device):
    """The streaming tracker through ``track_step_from_depth`` over the
    300-frame sweep: frames/s, median and p90 error of latched slots,
    latched and warm shares, gated; the card against the CPU over the first
    frames on the same triplets; one host read of ``steady`` a frame.
    Returns the K1 launches of the counted pass."""
    from perception_tpu_torch.models import object_tracking
    from perception_tpu_torch.models.cuboid import decimate
    from perception_tpu_torch.models.object_tracking import init_tracks, slot_template_normals, track_step_from_depth
    from perception_tpu_torch.models.objects import working_set
    from perception_tpu_torch.ops import ransac
    from perception_tpu_torch.ops.ransac import _sample_indices

    t0 = time.perf_counter()
    camera, templates_np, tmasks_np, depths_np, gts = tracking_scene()
    print(f"tracking scene: {TRACK_FRAMES} frames {camera.width}x{camera.height}, fx {camera.fx:.1f}, "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    cfg = tracking_config()
    K = cfg.max_tracks
    on = {}
    for dev in ("cpu", device):
        t, m = torch.from_numpy(templates_np).to(dev), torch.from_numpy(tmasks_np).to(dev)
        on[str(dev)] = (t, m, slot_template_normals(t, m))
    depths = torch.from_numpy(depths_np).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step(slots, depth, dev=device, **kw):
        t, m, tn = on[str(dev)]
        return track_step_from_depth(slots, depth, camera, t, m, kw.pop("gen", gen), cfg, template_normals=tn, **kw)

    step(init_tracks(cfg, device), depths[0])  # warm-up
    torch.cuda.synchronize()
    # The path, counted and timed.
    reset_launches()
    slots, hist = init_tracks(cfg, device), []
    t0 = time.perf_counter()
    for i in range(TRACK_FRAMES):
        slots, diag = step(slots, depths[i])
        hist.append((slots.pose, slots.latched, diag.used_warm))
    torch.cuda.synchronize()
    fps = TRACK_FRAMES / (time.perf_counter() - t0)
    counts = read_launches()
    print(f"tracker path: {TRACK_FRAMES} x track_step_from_depth: launches {counts}")
    require(counts == {"ransac_score": TRACK_FRAMES, "icp_gn": 0, "voxelhash_query": 0},
            f"expected {TRACK_FRAMES} K1 launches (one a frame) and no other kernel")
    pose = torch.stack([h[0] for h in hist]).cpu().numpy()
    latched = torch.stack([h[1] for h in hist]).cpu().numpy()
    warm = torch.stack([h[2] for h in hist]).cpu().numpy()
    require(np.isfinite(pose).all(), "tracker: non-finite pose")
    errs = np.linalg.norm(pose[..., :3, 3] - gts[..., :3, 3], axis=-1)[latched]
    med, p90 = float(np.median(errs) * 100), float(np.percentile(errs, 90) * 100)
    latched_pct = 100.0 * latched.mean()
    warm_pct = 100.0 * warm.sum() / max(latched.sum(), 1)
    print(f"tracker: {fps:.2f} frames/s, median error {med:.3f} cm, p90 {p90:.3f} cm, latched {latched_pct:.2f}%, "
          f"warm {warm_pct:.2f}% ({K} objects, {camera.width}x{camera.height})")
    require(latched_pct >= 95.0, "tracker: latched under 95%")
    require(med <= 2.0 and p90 <= 5.0, "tracker: median error over 2 cm or p90 over 5 cm")

    # The card against the port's CPU path, with the same RANSAC triplets.
    slots = {"cpu": init_tracks(cfg, "cpu"), str(device): init_tracks(cfg, device)}
    for i in range(TRACK_CPU_FRAMES):
        d, cam2 = decimate(torch.from_numpy(depths_np[i]), camera, cfg.depth_stride)
        p, m = cam2.backproject_depth(d, min_depth=0.05, max_depth=5.0)
        _, dm, _ = working_set(p, m, cfg.detection)
        idx = _sample_indices(torch.Generator().manual_seed(i), dm, cfg.detection.ransac_hypotheses)
        out = {}
        for dev in ("cpu", device):
            slots[str(dev)], diag = step(slots[str(dev)], depths[i].to(dev), dev, gen=None, indices=idx)
            out[str(dev)] = [x.cpu() for x in (*slots[str(dev)], diag.assigned)]
        (cp, cl, _, cm, _, ca), (gp, gl, _, gm, _, ga) = out["cpu"], out[str(device)]
        dt = float((cp[:, :3, 3] - gp[:, :3, 3]).norm(dim=-1).max())
        print(f"tracker frame {i} cuda vs cpu (same triplets): latched {gl.tolist()} / {cl.tolist()}, misses "
              f"{gm.tolist()} / {cm.tolist()}, assigned {ga.tolist()} / {ca.tolist()}, translation diff {dt * 1e3:.6f} mm")
        require(torch.equal(cl, gl) and torch.equal(cm, gm) and torch.equal(ca, ga) and dt <= 1e-3,
                f"tracker frame {i}: CUDA and CPU disagree")

    # One host read a frame (steady), and the plane refit's eigh.
    steady = f"models/object_tracking.py:{source_line(object_tracking, 'steady = bool(')}"
    eigh = f"ops/ransac.py:{source_line(ransac, 'torch.linalg.eigh(')}"
    slots = init_tracks(cfg, device)
    torch.cuda.synchronize()
    for i in range(TRACK_SYNC_FRAMES):
        with recorded_syncs() as sites:
            slots, _ = step(slots, depths[i])
        require_syncs(f"tracker frame {i}", sites, {steady: 1, eigh: 1})

    frames = itertools.cycle(range(TRACK_SYNC_FRAMES, TRACK_FRAMES))
    holder = [slots]

    def one():
        holder[0], _ = step(holder[0], depths[next(frames)])

    print("tracker stage ms (synchronized, one steady frame): " + str(stage_ms(
        one, {"front end": [(object_tracking, "_front_end")], "icp": [(object_tracking, "icp_point_to_plane")]})))
    busy, wall, by_name, _ = device_profile(one, 10)
    print(f"tracker profile (torch.profiler, 10 steady frames): device busy share {busy:.4f}, wall {wall:.2f} ms "
          f"a frame, top device ms a frame {top_ms(by_name)}")
    return counts["ransac_score"]


def posenet_ops(net, x):
    """f32 operations of one forward of ``net`` on ``x``, per frame: 2 per
    multiply-add of each convolution (biases, ReLUs and pools are left
    out), from each conv's output shape on this input."""
    ops = []

    def hook(module, inputs, out):
        k = module.weight
        ops.append(2 * out[0].numel() * k.shape[1] * k.shape[2] * k.shape[3])

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            net(x[:1])
    finally:
        for h in handles:
            h.remove()
    return sum(ops)


def event_ms(fn, reps=TIMED_REPS, calls=TIMED_CALLS):
    """(median, min, max) ms of one ``fn()`` over ``reps`` runs of ``calls``
    calls each, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / calls)
    return statistics.median(runs), min(runs), max(runs)


def fmt_ms(t, per=1):
    return f"{t[0] / per:.4f} ms (runs {t[1] / per:.4f}-{t[2] / per:.4f})"


def compare_people(label, got, want, kp_tol=POSE_KP_TOL, score_tol=POSE_SCORE_TOL):
    """Hold People ``got`` (any device) to ``want`` (CPU): the same people,
    part counts and present parts, keypoints within ``kp_tol`` px."""
    got = type(got)(*(t.cpu() for t in got))
    same = (torch.equal(got.mask, want.mask) and torch.equal(got.num_parts, want.num_parts)
            and torch.equal(got.keypoints[..., 2] > 0, want.keypoints[..., 2] > 0))
    kp = float((got.keypoints - want.keypoints).abs().max())
    sc = float((got.score - want.score).abs().max())
    print(f"{label}: people {int(want.mask.sum())}, same people, parts and peaks {same}, keypoints max diff "
          f"{kp:.3e} px, scores max diff {sc:.3e}")
    require(same and kp <= kp_tol and sc <= score_tol,
            f"{label}: card and CPU disagree beyond {kp_tol} px / {score_tol}")


def run_pose(device):
    """The pose and hand path of the CNN facade.

    1. The trained fixtures: the tiny MPI_15 PoseNet on POSE_SCENES seeded
       scenes at 128x128 in one batched ``extract_people`` (PCK and recall
       on the card equal to the CPU's and at the JAX package's gate, 0.75
       and 0.9; its own values are POSE_JAX_PCK), the hand net on
       HAND_SCENES noisy scenes (mean landmark error < 3 px in all but
       one), and the facade's pose -> hand chain on one frame; card
       against CPU each; host syncs of the chain held to none.
    2. Full width: ``PoseNet()`` at its defaults (BODY_25; backbone
       32/64/128; 3 stages of width 96, depth 4) with ``init_posenet``'s
       seeded weights at 368x368: maps card against CPU, the decode of the
       card's maps on the card against the CPU, and one 480x640 frame
       (the antialiased downsample).
    3. Times by CUDA events: ``extract_people`` a frame at B=1 and B=8,
       the CNN alone, ``resize_and_merge`` (26, 46, 46) -> 368x368,
       ``nms_heatmap`` (25, 368, 368) at K=32, the decode's stages, the
       device busy share by torch.profiler, and the CNN's bound (f32
       operations at 67 TFLOP/s).
    """
    import copy

    from perception_tpu_torch.models import hand_fixture as HF
    from perception_tpu_torch.models import pose, pose_fixture as PF
    from perception_tpu_torch.models.hand_data import hand_box
    from perception_tpu_torch.ops.heatmap import nms_heatmap, resize_and_merge
    from perception_tpu_torch.ops.resize import resize
    from perception_tpu_torch.utils.keypoints import keep_top_n_people

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    nets = {d: PF.load_fixture(d) for d in (device, cpu)}
    hands = {d: HF.load_fixture(d) for d in (device, cpu)}

    # 1a. Pose fixture: PCK on the card and the CPU, one batched call each.
    scenes, images = PF.sample_scenes(np.random.default_rng(POSE_SEED), POSE_SCENES)
    x = {d: torch.from_numpy(images).to(d) for d in (device, cpu)}
    torch.cuda.synchronize()
    reset_launches()
    with recorded_syncs() as sites:
        card = PF.extract_fixture_people(nets[device], x[device])
    torch.cuda.synchronize()
    counts = read_launches()
    require_syncs(f"pose fixture extract_people (B={POSE_SCENES})", sites, {})
    print(f"pose path launches of K1-K4 (none on this path: its CNN is cuDNN, its decode PyTorch): {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the pose path")
    host = PF.extract_fixture_people(nets[cpu], x[cpu])
    compare_people(f"pose fixture {PF.FIXTURE_HW} B={POSE_SCENES} cuda vs cpu", card, host)
    pck = {d: PF.pck_of_people(p.keypoints.cpu().numpy(), p.mask.cpu().numpy(), scenes)
           for d, p in ((device, card), (cpu, host))}
    print(f"pose fixture PCK, recall on {POSE_SCENES} scenes (seed {POSE_SEED}): cuda {pck[device]}, cpu {pck[cpu]}, "
          f"JAX package {POSE_JAX_PCK}; gate 0.75, 0.9")
    require(pck[device] == pck[cpu], "pose fixture: PCK on the card differs from the CPU's")
    require(pck[device][0] >= 0.75 and pck[device][1] >= 0.9, "pose fixture: PCK / recall under the gate")

    # 1b. Hand fixture: landmark error per scene, card against CPU.
    errs, diffs = [], []
    for scene, img in HF.sample_scenes(np.random.default_rng(HAND_SEED), HAND_SCENES):
        box = torch.from_numpy(hand_box(scene.joints))
        out = {d: HF.extract_hand_tiny(hands[d], torch.from_numpy(img).to(d), box.to(d)) for d in (device, cpu)}
        uv, m = out[device][0].cpu(), out[device][1].cpu()
        require(torch.equal(m, out[cpu][1]), "hand fixture: landmark masks differ between card and CPU")
        diffs.append(float((uv - out[cpu][0]).abs().max()))
        errs.append(float(np.linalg.norm(uv.numpy() - scene.joints, axis=-1)[m.numpy()].mean()))
    print(f"hand fixture: mean landmark error per scene {[round(e, 3) for e in errs]} px (gate < 3 px in "
          f"{HAND_SCENES - 1} of {HAND_SCENES}); cuda vs cpu max diff {max(diffs):.3e} px")
    require(sum(e < 3.0 for e in errs) >= HAND_SCENES - 1, "hand fixture: landmark error gate missed")
    require(max(diffs) <= HAND_TOL, "hand fixture: card and CPU landmarks differ")

    # 1c. The facade's pose -> hand chain on one fixture frame (top 2 people).
    def chain(d):
        img = x[d][0]
        ppl = PF.extract_fixture_people(nets[d], img)
        kp, _, m = keep_top_n_people(ppl.keypoints, ppl.score, ppl.mask, 2)
        return HF.hands_from_pose(hands[d], img.mean(dim=-1) * 255.0, kp, m, n_people=2)

    torch.cuda.synchronize()
    with recorded_syncs() as sites:
        card_h = chain(device)
    torch.cuda.synchronize()
    require_syncs("pose -> hand chain", sites, {})
    host_h = chain(cpu)
    card_h = {k: v.cpu() for k, v in card_h.items()}
    same = all(torch.equal(card_h[k], host_h[k]) for k in ("box_valid", "landmark_mask"))
    box_d = float((card_h["boxes"] - host_h["boxes"]).abs().max())
    lm_d = float((card_h["landmarks"] - host_h["landmarks"]).abs().max())
    print(f"pose -> hand chain: {int(card_h['box_valid'].sum())} valid hand boxes, {int(card_h['landmark_mask'].sum())} "
          f"landmarks; cuda vs cpu: masks equal {same}, boxes max diff {box_d:.3e} px, landmarks {lm_d:.3e} px")
    require(same and box_d <= CHAIN_TOL and lm_d <= CHAIN_TOL, "pose -> hand chain: card and CPU disagree")
    print(f"pose fixtures: {time.perf_counter() - t_phase:.1f} s")

    # 2. Full width: BODY_25 PoseNet() at 368x368 with seeded weights.
    topology = "BODY_25"
    parts, pairs = pose.lookup_topology(topology)
    wide = pose.init_posenet(torch.Generator().manual_seed(0), topology, device=device)
    wide_cpu = copy.deepcopy(wide).to(cpu)
    frames = {cpu: torch.from_numpy(np.random.default_rng(1).random((WIDE_BATCH,) + WIDE_HW + (3,), dtype=np.float32))}
    frames[device] = frames[cpu].to(device)
    with torch.no_grad():
        maps = {d: net(frames[d][:1].permute(0, 3, 1, 2).contiguous()) for d, net in ((device, wide), (cpu, wide_cpu))}
    for i, name in enumerate(("pafs", "heatmaps")):
        a, b = maps[device][i].cpu(), maps[cpu][i]
        diff, scale = float((a - b).abs().max()), float(b.abs().max())
        print(f"full width {topology} {WIDE_HW} {name} {tuple(a.shape)}: cuda vs cpu max abs diff {diff:.3e} "
              f"(max |map| {scale:.3f})")
        require(diff <= WIDE_MAP_RTOL * max(scale, 1.0), f"full width: {name} differ beyond {WIDE_MAP_RTOL}")
    # The decode of the card's merged maps, on the card and on the CPU: as
    # they are, and scaled to a maximum of 1 (random weights give maps of
    # ~0.01, under the peak threshold of 0.1; scaled, every part has its 32
    # peaks and limbs pass the PAF test).
    paf, hm = maps[device]
    merged = (pose._merge([paf[0]], (WIDE_HW[0] // 8, WIDE_HW[1] // 8)),
              pose._merge([hm[0, :len(parts)]], WIDE_HW))
    unit = (merged[0] / merged[0].abs().amax(), merged[1] / merged[1].amax())
    for label, m in (("as they are", merged), ("scaled to unit maximum", unit)):
        torch.cuda.synchronize()
        with recorded_syncs() as sites:
            card = pose.decode_people(*m, pairs, num_parts=len(parts), paf_stride=8.0)
        torch.cuda.synchronize()
        require_syncs(f"full width decode_people ({label})", sites, {})
        host = pose.decode_people(*(t.cpu() for t in m), pairs, num_parts=len(parts), paf_stride=8.0)
        compare_people(f"full width {topology} decode of the card's maps {label}, cuda vs cpu", card, host)
    ppl = pose.extract_people(wide, frames[device][0], topology, net_hw=WIDE_HW)
    require(all(bool(torch.isfinite(t.float()).all()) for t in ppl), "full width: non-finite people")

    vga = torch.from_numpy(np.random.default_rng(2).random((480, 640, 3), dtype=np.float32))
    small = {d: resize(vga.to(d).movedim(-1, -3), WIDE_HW) for d in (device, cpu)}
    rd = float((small[device].cpu() - small[cpu]).abs().max())
    ppl = pose.extract_people(wide, vga.to(device), topology, net_hw=WIDE_HW)
    torch.cuda.synchronize()
    print(f"full width 480x640 frame: antialiased downsample to {WIDE_HW} cuda vs cpu max diff {rd:.3e}; "
          f"{int(ppl.mask.sum())} people, keypoints {tuple(ppl.keypoints.shape)} finite "
          f"{bool(torch.isfinite(ppl.keypoints).all())}")
    require(rd <= 1e-5 and bool(torch.isfinite(ppl.keypoints).all()), "full width 480x640: downsample or output")

    # 3. Times on the card.
    ops = posenet_ops(wide, frames[device].permute(0, 3, 1, 2))
    bound_ms = ops / PEAK_F32_OPS * 1e3
    one, eight = frames[device][0], frames[device]
    nchw = {b: frames[device][:b].permute(0, 3, 1, 2).contiguous() for b in (1, WIDE_BATCH)}
    with torch.no_grad():
        t_e1 = event_ms(lambda: pose.extract_people(wide, one, topology, net_hw=WIDE_HW))
        t_e8 = event_ms(lambda: pose.extract_people(wide, eight, topology, net_hw=WIDE_HW))
        t_c1 = event_ms(lambda: wide(nchw[1]))
        t_c8 = event_ms(lambda: wide(nchw[WIDE_BATCH]))
    s8 = (WIDE_HW[0] // 8, WIDE_HW[1] // 8)
    m46 = torch.from_numpy(np.random.default_rng(3).random((1, len(parts) + 1) + s8, dtype=np.float32)).to(device)
    hms = torch.from_numpy(np.random.default_rng(4).random((len(parts),) + WIDE_HW, dtype=np.float32)).to(device)
    t_rm = event_ms(lambda: resize_and_merge(m46, WIDE_HW), calls=20)
    t_nms = event_ms(lambda: nms_heatmap(hms, threshold=0.1, max_peaks=32), calls=20)
    t_dec = event_ms(lambda: pose.decode_people(*unit, pairs, num_parts=len(parts), paf_stride=8.0), calls=20)
    print(f"full width {topology} {WIDE_HW} times (CUDA events, median of {TIMED_REPS} runs of {TIMED_CALLS}):")
    print(f"  extract_people B=1: {fmt_ms(t_e1)} a frame; B={WIDE_BATCH}: {fmt_ms(t_e8, WIDE_BATCH)} a frame "
          f"({fmt_ms(t_e8)} a call)")
    print(f"  CNN alone B=1: {fmt_ms(t_c1)}; B={WIDE_BATCH}: {fmt_ms(t_c8, WIDE_BATCH)} a frame")
    print(f"  CNN bound: {ops / 1e9:.3f} GFLOP a frame (2 per multiply-add) at {PEAK_F32_OPS / 1e12:.0f} TFLOP/s "
          f"= {bound_ms:.4f} ms a frame; share of bound B=1 {bound_ms / t_c1[0]:.4f}, "
          f"B={WIDE_BATCH} {bound_ms * WIDE_BATCH / t_c8[0]:.4f}")
    print(f"  resize_and_merge {tuple(m46.shape)} -> {WIDE_HW}: {fmt_ms(t_rm)}; nms_heatmap "
          f"({len(parts)}, {WIDE_HW[0]}, {WIDE_HW[1]}) K=32: {fmt_ms(t_nms)}; decode_people (maps scaled to unit maximum): {fmt_ms(t_dec)}")
    stages = {"cnn": [(wide, "forward")], "merge": [(pose, "_merge")], "nms": [(pose, "nms_heatmap")],
              "paf scores": [(pose, "paf_pair_scores")], "greedy": [(pose, "greedy_match")],
              "assemble": [(pose, "assemble_people")]}
    for b, frame in ((1, one), (WIDE_BATCH, eight)):
        pose.extract_people(wide, frame, topology, net_hw=WIDE_HW)
        print(f"  extract_people B={b} stage ms (synchronized): "
              f"{stage_ms(lambda: pose.extract_people(wide, frame, topology, net_hw=WIDE_HW), stages)}")
        busy, wall, by_name, n_ops = device_profile(lambda: pose.extract_people(wide, frame, topology, net_hw=WIDE_HW), 5)
        print(f"  extract_people B={b} profile (torch.profiler, 5 calls): device busy share {busy:.4f}, wall "
              f"{wall:.3f} ms a call, {n_ops / 5:.0f} device ops a call, top device ms a call {top_ms(by_name)}")
    print(f"pose phase: {time.perf_counter() - t_phase:.1f} s")


def json_times(t):
    """A kernel's times for the JSON line: ``ms`` the eager wrapper call,
    ``device_ms`` its device time by graph replay. No single PyTorch call
    computes any of the three functions (a range scan or a fused NN +
    system), so there is no library time."""
    return {"ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    from perception_tpu_torch.ops.kernels import build

    t_run = time.perf_counter()
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, KERNELS))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNELS, libs):
        build.load_library(name)
        print(f"{lib.relative_to(build.BUILD_DIR.parents[1])}:")
        print(lib.with_name(lib.name + ".log").read_text().strip())

    k1_err = check_kernel(device)
    k2_err = check_k2(device)
    k3_err = check_k3(device)

    (cuboid_b1_launches, cuboid_b8_launches), one, batch = run_slice(device)
    t0 = time.perf_counter()
    scene = slam_scene()
    print(f"SLAM scene: {SLAM_FRAMES} frames {scene[0].width}x{scene[0].height}, fx {scene[0].fx:.1f}, "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    odo_launches, _ = run_odometry_paths(device, scene)
    slam_launches = run_slam_paths(device, scene)
    del scene
    mode_launches = run_cuboid_modes(device)
    obj_launches = run_objects(device)
    track_launches = run_tracker(device)
    run_pose(device)

    k1_times = time_kernel(device)
    k2_times = time_k2(device)
    k3_times = time_k3(device)
    fps1, runs1 = frames_per_s(lambda: [one(i) for i in range(FRAMES)], FRAMES)
    fps8, runs8 = frames_per_s(batch, FRAMES)
    print(f"cuboid end to end: B=1 {fps1:.2f} frames/s (passes {[round(r, 2) for r in runs1]}), "
          f"B={FRAMES} {fps8:.2f} frames/s (passes {[round(r, 2) for r in runs8]})")

    print(f"run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": [
        *({
            "name": "ransac_score",
            "shape": shape,
            "route": "cuda",
            "source": "perception_tpu_torch/csrc/ransac_score.cu",
            "replaces": "perception_tpu/ops/pallas/ransac_score.py:60",
            "launches": launches,
            "max_abs_err": k1_err,
            **json_times(k1_times[bn]),
            "floor_ms": k1_times[bn]["floor_ms"],
        } for shape, launches, bn in (
            ("B=1 N=8192 K=1024 (cuboid, one frame a call)", cuboid_b1_launches, (1, 8192)),
            ("B=8 N=8192 K=1024 (cuboid batches: default, cc, p2p; with pcl_parity's one B=2 call)",
             cuboid_b8_launches + mode_launches, (8, 8192)),
            ("B=1 N=32768 K=1024 (detect_object)", obj_launches, (1, 32768)),
            ("B=1 N=24576 K=1024 (tracker)", track_launches, (1, 24576)),
        )),
        {
            "name": "icp_gn",
            "route": "cuda",
            "source": "perception_tpu_torch/csrc/icp_gn.cu",
            "replaces": "perception_tpu/ops/pallas/icp_gn.py:223",
            "launches": odo_launches["icp_gn"] + slam_launches["icp_gn"],
            "max_abs_err": k2_err,
            **json_times(k2_times[(4096, 8192)]),
        },
        {
            "name": "voxelhash_query",
            "route": "cuda",
            "source": "perception_tpu_torch/csrc/voxelhash_query.cu",
            "replaces": "perception_tpu/ops/voxelhash.py:285 (K3), perception_tpu/ops/voxelhash.py:201 (K4)",
            "launches": odo_launches["voxelhash_query"] + slam_launches["voxelhash_query"],
            "max_abs_err": k3_err,
            **json_times(k3_times[(32768, 2048)]),
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
