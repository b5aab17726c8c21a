"""Smoke run of perception_tpu_torch on one CUDA card.

Builds the port's three kernels from ``perception_tpu_torch/csrc`` (one
``nvcc`` per source, all started together) and holds each against its
plain PyTorch version at the shapes its path gives it: K1, fused RANSAC
scoring, bit-exact (B=1, 2, 4 and 8 at N=8192 for the cuboid, 32768 for the
detection service, 24576 for the tracker, and K=1023, B=3 edges; random
points, and points exactly at +-tau, one ulp past it, -0.0, NaN and +-inf,
valid and masked; and B=1 N=8192 K=512 for the surface frame), its launch
plan printed and held to at least 8 warps an SM at the six K=1024 path
shapes (K=512 is exempt: 128 blocks, 7.76 warps an SM); K2, the fused Gauss-Newton ICP system,
with equal gate counts and M within rtol/atol 1e-4; K3+K4, the voxel-hash query,
bit-exact below and above 49152 table rows, and on the clouds and shapes of
the bench's nearest-neighbour crossover. Then drives the port's
paths through their entry points, each with the kernels' launch counts
set to 0 just before it and read just after:

- the cuboid pipeline at 640x480 on the 8 bench frames, through
  ``cuboid_pipeline_from_depth`` (one frame at a time) and
  ``cuboid_pipeline_batch`` (B=8): acceptance, pose against ground truth,
  one K1 launch per RANSAC call, and the card against the port's CPU path;
- SLAM odometry at 640x480 through ``run_odometry`` over 40 frames of the
  textured-room sweep, under four configurations (keyframe mode with the
  op graph and with K2; map mode at map_budget 32768 with the shortlist
  and with the voxel hash): ATE, overlap, exact launch counts, the card
  against the port's CPU path over the first 5 frames (K2 and both map
  engines), and the shortlist's first build from the same state equal to
  the CPU's; map mode's frames/s; then ``bench/odometry_bench.run`` at its
  full sizes (its 10-frame room sweep, keyframe mode at 4096 x 8192 and
  8192 x 32768 on the op graph and on K2; frames/s, ms a frame and the
  fused speedup): K2 exactly 410 launches at each shape, counted by shape,
  and the two modes' last poses within K2's tolerance (1e-4);
- the keyframe SLAM system at 640x480 through ``run_slam`` over all 300
  frames of the sweep (``benchmarks/slam_bench.py``'s settings), with BA
  and without on K2, and in map mode at map_budget 32768 on the voxel
  hash: ATE, live loop closures, BA runs that never raise their cost,
  exact launch counts; the card against the port's CPU path over the
  first 12 frames (same RANSAC triplets); ``slam_step``'s host syncs,
  from torch's sync debug mode, held to the reads it states; a
  stage-timed pass (odometry, features, matching, RANSAC+PnP, BA, pose
  graph; ms per tracking / promotion frame) and the counted run's wall
  time (the benchmark's SLAM rows below are the timed passes);
- the cuboid pipeline's other modes on the 8 bench frames at B=8:
  ``cluster_filter="cc"`` and ``icp_mode="p2p"`` (acceptance, pose against
  ground truth, the card against the CPU), and ``CuboidConfig.pcl_parity()``
  on the first frames, timed;
- the detection service through ``detect_object`` in
  ``bench/objects_bench.py``'s setting (the 640x480 clutter scene, the
  four captured class templates and a plate that matches nothing): success
  and chamfer error per class, the plate rejected, the card against the
  CPU on the same triplets, the eraser 20 times on the card (every call
  the same pose) and 20 on the CPU in a worker process beside the run
  (the spread of its chamfer and of the card-CPU translation), the host
  syncs held to the stated count; ms a call per class by
  ``objects_bench.run`` (one K1 launch a call, 24, counted by shape) and
  of the plate;
- the streaming tracker through ``track_step_from_depth`` in
  ``benchmarks/tracking_bench.py``'s setting (640x480, three cuboids): the
  card against the CPU over the first frames, one host read of ``steady``
  a frame, stage ms and the busy share (its 300-frame run, gated, is the
  benchmark's tracker row below);
- the pose and hand path of the CNN facade, which runs none of the three
  kernels (its CNN is cuDNN, its decode PyTorch): the repo's trained tiny
  MPI_15 PoseNet through ``extract_people`` on 8 seeded scenes at 128x128
  in one batch (PCK and recall equal to the CPU's and at the JAX
  package's gate of 0.75 and 0.9), the trained hand net on 8 noisy hand
  scenes (mean landmark error under 3 px in 7 of 8), and the facade's
  pose -> hand chain on one frame, each on the card against the CPU and
  with no host sync; ``PoseNet()`` at full width (BODY_25, 3 stages) at
  368x368 (``bench/pose_bench.py``'s setting) with seeded weights:
  maps and the decode of the card's maps on the card against the CPU, one
  480x640 frame through the antialiased downsample; ``pose_bench.run`` at
  its full sizes (``extract_people`` ms a frame at B=1 and B=8,
  ``resize_and_merge`` and ``nms_heatmap`` at the reference's stage
  shapes), the CNN alone against its bound (f32 operations at 67
  TFLOP/s), the decode's stages, the device busy share;
- the face family, which runs none of the kernels either: the trained
  face fixture's chain from pixels (detector -> crop -> landmarks ->
  head-pose PnP -> gaze -> AUs) on 10 seeded 128x128 scenes with
  ``tests/test_face_e2e.py``'s gates, and ``multi_face_step`` on
  ``tests/test_face_multi.py``'s three-face 256x256 scene with its gates
  (three slots, two throttled frames, the per-face AU02 gate), card
  against CPU, no host sync;
- the ``Perception`` facade at ``benchmarks/facade_bench.py``'s setting
  (MPI_15 fixture, 4 face slots, hands of 2 people, 256x256 three-face
  frames): faces tracked and carried over 120 frames, stage ms, busy share, no host sync, the card's
  datum against the CPU's (its timed pass is the benchmark's facade row
  below); and at
  full width (BODY_25 PoseNet at 368x368 with seeded weights on 480x640
  frames with three faces): ms a frame, card against CPU. In both
  comparisons the face landmark heatmaps are held within 1e-4, and a
  landmark whose heatmap peaks in two cells that rounding alone orders
  (``tied_peaks``) is held to the CPU's decode of the card's heatmaps
  instead of the CPU's landmark;
- the person tracker (pyramidal LK + greedy matching) at
  ``TrackerConfig()``'s defaults over 60 frames of 8 BODY_25 people with
  padding rows on a shifting 480x640 texture: no id switch, ids and
  keypoints card against CPU, no host sync, ms a step;
- the reference's cuboid_detection leaf nodes on the 8 bench frames at
  640x480 with a seeded colour image (the box painted red on a texture):
  ``detect_red_object`` (the rectangle equal to scipy's opening of the red
  pixels), ``project_bbox`` (the box's corners inside it),
  ``filter_by_rect`` on the decimated cloud (every box point kept),
  ``segment_ground_plane`` and ``estimate_surface_frame`` (exactly 3 K1
  launches at B=1 N=8192 K=512 a frame; orthonormal, det > 0.99, origin
  within 5 cm; valid on tests/test_models.py's tabletop scene), card
  against CPU on the same inputs and triplets, host syncs (the 3 eighs),
  ms a frame and a stage;
- OpenPose's 3-D chain: 48 rendered 640x480 views of a 9x6 board (4
  cameras x 12 poses) through ``detect_chessboard_native``,
  ``calibrate_camera`` a camera, ``pairwise_extrinsics`` and
  ``joint_extrinsics_refine`` (C=4, B=12, P=54), 8 BODY_25 people through
  ``triangulate``, ``fit_body_from_body25`` and ``save_bvh``, and a
  ``StereoCamera`` round trip, with the JAX tests' gates, card against CPU
  and each entry point's host syncs;
- the command line from files (``run_cli``, right after the SLAM phase,
  on its rendered sweep), through ``perception_tpu_torch.cli.main`` with
  the native host library built and required: ``cuboid`` on the 8 bench
  frames as 16-bit mm PNGs with the template as ascii and binary PCD (8/8
  within 2 cm, one K1 launch a call), ``objects`` on the 640x480 clutter
  scene as a mm PNG with each class's template as PCD, at the CLI's
  defaults (the JAX CLI's answers on the same files: success, winning
  cluster, sizes and size difference equal, chamfer within 0.05 cm),
  ``odometry --tum`` and ``slam --tum`` over the sweep's first 100 frames
  written as a TUM sequence at 640x480 (ATE at most 2 cm, the ``--out``
  trajectory read back and within 1e-4 of ``run_odometry`` /
  ``run_slam`` on the decoded arrays, frames/s from files), ``pose
  --image`` (the people of the in-memory facade); the PNG decode ms a
  frame, below an odometry step, and the sequence's read + decode rate
  with and without the native read-ahead.

- the training path, which runs none of the kernels either (its
  convolutions and their gradients are cuDNN's, in float32): example
  06's MPI_15 PoseNet (``init_posenet``) at 368x368, B=8, on one fixed
  ``make_batch`` batch (up to 4 people a scene) made on the card: one SGD
  step against the CPU's from the same weights and batch (loss within
  1e-5 relative, each gradient within 2e-3 of its tensor's largest,
  parameters within 1e-6), 10 Adam steps at 1e-3 (finite losses, the last
  below the first), no host sync in a step (torch's sync debug mode), ms
  a step (median of 7 by CUDA events), GFLOP a step
  (``utils/roofline.cost_of``) and its share of the f32 peak,
  ``max_memory_allocated``; a ``TrainState`` snapshot restored bit-equal;
  ``tools_torch/train_hand_fixture.py`` from ``init_tiny`` for 1000 steps
  (final mean landmark error below the untrained net's, at most 4 px and
  at most 1.5x the JAX tool's 2.96 px at the same count), ms a step; one
  SGD step each of the pose and face fixture losses from the committed
  fixtures on batches made on the card, against the CPU as above; each
  trained net written by ``save_fixture`` and read back as its float16
  weights; no K1-K4 launch; and a SLAM session (``bench_config()``,
  640x480) saved with ``save_npz`` after frame 11 of 24, loaded into a
  fresh state and resumed: the same promotions, poses within 1e-4 of the
  uninterrupted run's.
- the multi-device layer, which runs none of the kernels either (its
  per-rank work is plain PyTorch, its collectives ``torch.distributed``):
  ``perception_tpu_torch.parallel.dryrun.run``, whose ranks are spawned
  processes, so this process never joins a process group, at the dry
  run's headline shapes (distributed ICP, BA, both pose graphs, the
  data-parallel step of example 06's MPI_15 PoseNet at 368x368, B=8,
  map-sharded odometry; the dry run's docstring), each rank held to a
  single-rank run of the step and to the truth, its replicated outputs
  bit-identical across ranks: 1 rank over NCCL, then 2 and 4 ranks
  sharing the card over gloo (gloo moves the CUDA tensors itself through
  host memory; NCCL takes one rank a card), and the same 2 ranks on the
  CPU, untimed and without their own single-rank runs, against which the
  card's 2 are held (ICP and map transforms, BA's poses and landmarks,
  the pose graphs' poses within 1e-4; the training step's loss within
  1e-5 relative and each gradient within 2e-3 of its tensor's largest);
  ms a call of each step at each rank count and the data-parallel step's
  share of the f32 peak. Ranks that share one card show the structure of
  the sharding, not a cluster's speed.
- the examples (``run_examples``): every ``examples_torch`` example's
  ``main()`` (and ``main_facade()``) on the card with its own asserts and
  exactly its K1 launches (1, 1, 4 and 10 for 01, 02, 09 and 12, none
  elsewhere; 07 and 13 spawn their gloo fleets on the card); 05, 06, 08,
  10's viewer and 11 again on the CPU, the card held to them (05: the
  same keyframes and edges, ATE within 5 mm; 06: losses within 1e-3
  relative; 08: within 1e-4 and the display images equal; 10: the orbit
  frames equal, and equal to the plain renderer; 11: gates equal, the rest
  within 1e-3). Then the leaves at full width: ``Gui3D`` at 480x640 over
  the whole backprojected 640x480 bench frame (each frame equal to the
  numpy plain version, ms a frame against it), ``depth_to_vis`` and
  ``cvt_color_for_display`` (32FC1 dynamic, 32SC1 labels) card against
  CPU, imgcodec round trips of 640x480 rgb8 / 16UC1 / 32FC1 images
  (big-endian and PNG), COCO results of the full-width ``PoseNet()``'s
  people on run_pose's 8 frames written and read back equal,
  ``tools_torch/make_tum_fixture.py`` against the committed fixture and
  ``tools_torch/fixtures_robustness.py`` on the card against FIXTURES.md.
- the port's headline benchmark (``run_bench``): ``cli.main(["bench"])``
  in this process at ``bench.py``'s full sizes, its JSON line printed and
  held: the metric; frames/s at B = 1, 2, 4 and 8 with their spreads, the
  value the best of them; ``vs_baseline`` the value over the median of 3
  CPU-baseline passes; the SLAM rows (keyframe mode with BA and without,
  map fusion at 32768; ``bench.py``'s configurations, on the op graph and
  the shortlist) within 2 cm ATE, BA runs and loop closures; the
  tracker's gates (latched >= 95%, median <= 2 cm, p90 <= 5 cm); 3 faces
  in the facade; ``agree_pct`` and ``agree_cold_pct`` 100 at the four NN
  sizes; no ``*_error`` key; K1 / K2 / K3+K4 launches, counted by shape
  in the wrappers, exactly those worked out from the bench's loops
  (``bench_launches``); the phase's peak device memory. The kernels line
  takes the bench's launches from those counts by shape.
- the per-stage roofline (``run_stage_profile``): ``bench/profile_stages.run``
  at the JAX script's sizes, each of its 12 stages' rows printed (ms by
  CUDA events over 50 calls, operations and bytes counted from the
  stage's shapes and data, both shares at most 100% of the card's peaks)
  and its K1 / K3+K4 launches by shape held exactly (52 at (1, 8192, 1024)
  in the RANSAC and full-pipeline stages, 52 at 2048 queries x 33792 rows
  in the voxel-hash stage, none elsewhere);
- ``bench/facade_profile.run`` (the facade's four extractor subsets, 60
  frames each; the JAX script's rows; no kernel launch),
  ``bench/sweep_config.run`` (seven CuboidConfig variants over the 8 bench
  scenes: no variant may fail, each variant's acceptance equal to the
  port's on the CPU, K1 56 launches a variant by shape) and
  ``bench/decay_sweep.run`` at map_decay 0.5 (300 frames, 640x480, BA,
  a 32k map: ATE within its range, loop closures, keyframes and BA runs
  exactly).

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

Every phase runs under PyTorch's default TF32 flags (cuDNN's on): the
package keeps its convolutions and matmul sums in float32 itself
(``_tensor.fp32``), and the card-against-CPU checks hold it to that.

Prints the card, each check and the times, the run's wall time; then a
JSON line of the kernels; and last ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, when there is no card or any check fails.

Run from the repository root: ``python3 chip_smoke.py``
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perception_tpu_torch.bench import (
    decay_sweep,
    facade_profile,
    objects_bench,
    odometry_bench,
    pose_bench,
    profile_stages,
    sweep_config,
)
from perception_tpu_torch.ops.kernels import wrappers

FRAMES = 8
K1_TIMED = ((1, 8192), (2, 8192), (4, 8192), (8, 8192), (1, 32768), (1, 24576))  # the path shapes (B, N) at K=1024
K1_SURFACE = (1, 8192, 512)  # (B, N, K): estimate_surface_frame's three fits on the work cloud
K1_EXAMPLES = ((1, 32768, 256), (1, 16384, 1024))  # examples 09 and 12: shapes no other path gives K1
KERNEL_SHAPES = [  # (B, N, K, inputs): "random", "edges" (k1_edge_inputs) or "all masked"
    *((b, n, 1024, inputs) for b, n in K1_TIMED for inputs in ("random", "edges")),
    *((b, n, k, inputs) for b, n, k in ((1, 777, 100), (3, 777, 100), (1, 8192, 1023))
      for inputs in ("random", "edges")),
    (1, 8192, 1024, "all masked"),
    *((*shape, inputs) for shape in (K1_SURFACE, *K1_EXAMPLES) for inputs in ("random", "edges")),
]
K1_MIN_WARPS_PER_SM = 8  # what K1's launch plan must give each path shape (K1_SURFACE exempt: check_kernel)
K1_INSTRUCTIONS = 8      # a pair: 3 multiplies, 3 adds, the compare, the count (no FMA)
TAU = 0.015
KERNELS = ("ransac_score", "icp_gn", "voxelhash_query")
K2_SHAPES = [  # (R, N, M, all source points masked); the first three are odometry's
    (1, 4096, 8192, False),    # default OdometryConfig
    (1, 2048, 4096, False),    # the SLAM bench's keyframe mode
    (1, *odometry_bench.BUDGETS[1], False),  # odometry_bench's large budget pair
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
SLAM_CPU_FRAMES = 12     # card against CPU (and host syncs): two promotions, each with a BA run
PROFILE_FRAMES = 30      # slam_step calls under torch.profiler (keyframe+BA K2, map hash)
OBJ_CLASSES = objects_bench.CLASSES
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
# The JAX package's command line on the same scene stored as a 16-bit
# mm PNG, each class's template as a binary PCD, at its defaults
# (ObjectConfig(), --seed 0; objects_reference.py --cli, on the CPU):
# (success, winning cluster, size difference, cluster sizes, chamfer cm).
# run_cli holds the port's command line to the same answers, chamfer
# within 0.05 cm. At cluster_min_size 200 two clusters survive and the
# size winner is cluster 1 for every class: only the screwdriver lies there.
OBJ_CLI_JAX_REFERENCE = {
    "eraser": (True, 1, 248, [473, 308, 0, 0, 0, 0, 0, 0], 19.359),
    "screwdriver": (True, 1, 136, [473, 308, 0, 0, 0, 0, 0, 0], 0.106),
    "clamp": (True, 1, 23, [473, 308, 0, 0, 0, 0, 0, 0], 23.416),
    "marker": (True, 1, 215, [473, 308, 0, 0, 0, 0, 0, 0], 16.536),
}
TRACK_FRAMES = 300       # tracking_bench.py's camera_trajectory(300)
TRACK_CPU_FRAMES = 6     # tracker on the card against the CPU
TRACK_CHECK_FRAMES = 30  # the sweep's first frames, rendered for the tracker phase's checks
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
WIDE_HW = pose_bench.NET_HW  # the reference's own net resolution
WIDE_BATCH = pose_bench.BATCH
TIMED_REPS = 3           # timed runs (median, with the spread), each of TIMED_CALLS calls after a warm-up
TIMED_CALLS = 5
PEAK_F32_OPS = 67e12     # H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
FACE_SEED = 321          # the single-face scenes: the first FACE_SCENES of numpy's default_rng(FACE_SEED)
FACE_SCENES = 10         # tests/test_face_e2e.py's count
FACE_LM_TOL = 1e-3       # px: face boxes and landmarks, card against CPU
FACE_POSE_TOL = 1e-4     # head-pose matrix entries (m, and rotation entries ~rad), card against CPU
FACE_MAP_TOL = 1e-4      # face landmark heatmaps (peaks ~1), card against CPU: max abs diff
MULTI_HW = (256, 256)    # tests/test_face_multi.py's scene and facade_bench.py's frames
MULTI_OFFSETS = ((-0.14, -0.14), (0.14, -0.14), (0.0, 0.14))
MULTI_Z = 0.62
MULTI_SEED = 0
MULTI_SLOTS = 4
FACADE_SEED = 0
FACADE_STAGED = 8        # facade_bench.py: 8 pre-staged frames, 120 a pass
FACADE_FRAMES = 120
FULL_HW = (480, 640)     # the D435 colour resolution
# Three faces at 480x640: at the wrapper's fx (300 x 640 / 128 = 1500) a
# face at 3 m spans the pixels it spans in the 128x128 fixture at 0.6 m.
FULL_OFFSETS = ((-0.35, -0.2), (0.35, -0.2), (0.0, 0.25))
FULL_Z = 3.0
PERSON_FRAMES = 60
PERSON_COUNT = 8
PERSON_PADS = 4
PERSON_SHIFT = 2         # px a frame, the texture and the people


CLI_FRAMES = 100         # cli odometry / slam --tum over the sweep's first frames at 640x480: over all 300
                         # frames run_cli took 105.2 s on an H100 (34.8 s at 100), and the run has a
                         # time limit; the benchmark runs the whole 300-frame sweep in memory
CLI_POSE_TOL = 1e-4      # m and rotation entries: the --out file (6 decimals) against the in-memory run
LEAF_SEED = 40           # leaf_rgb's textures: numpy's default_rng(LEAF_SEED + frame)
CHAIN_CAMERAS = 4
CHAIN_BOARDS = 12
CHAIN_ROWS, CHAIN_COLS, CHAIN_SQUARE = 6, 9, 0.06  # a 9x6 inner-corner board of 6 cm squares
CHAIN_SEED = 7           # board poses: numpy's default_rng(CHAIN_SEED); noise and people from +1, +2
CHAIN_NOISE_PX = 0.3     # corner noise added to the detections (tests/test_calibration.py's)
CHAIN_PEOPLE = 8
CHAIN_BVH_FRAMES = 30
ERASER_CALLS = 20        # detect_object calls of the eraser on the same triplets, card and CPU
ERASER_CPU_THREADS = 3   # the CPU calls' worker process, beside the whole run on the 8-core host
TRAIN_TOPOLOGY = "MPI_15"  # example 06's PoseNet: init_posenet(gen, "MPI_15"), 3 stages, widths (32, 64, 128)
TRAIN_HW = (368, 368)    # the reference's net resolution
TRAIN_BATCH = 8
TRAIN_PEOPLE = 4         # people a scene at most (the fixture trainer's --n-people)
TRAIN_SEED = 12          # the net: torch.Generator(TRAIN_SEED); the batch: numpy's default_rng(TRAIN_SEED)
TRAIN_LR = 1e-3
TRAIN_STEPS = 10         # Adam steps whose losses must fall
TRAIN_TIMED = 7          # steps timed one by one by CUDA events after TRAIN_STEPS (median)
TRAIN_LOSS_RTOL = 1e-5   # one step, card against CPU: the loss
TRAIN_GRAD_TOL = 2e-3    # each gradient within this share of its tensor's largest: cuDNN's algorithms
                         # round otherwise than the CPU's (full-width maps: WIDE_MAP_RTOL) and 24 layers of
                         # backward carry it (4.08e-4 on the card's first run; the loss 1.2e-7 relative)
TRAIN_PARAM_TOL = 1e-6   # parameters after one SGD step at TRAIN_LR
HAND_TRAIN_STEPS = 1000  # tools_torch/train_hand_fixture.py from init_tiny, evaluated every 250 steps
HAND_TRAIN_EVAL = 250
# tools/train_hand_fixture.py --cpu --steps 1000 --eval-every 250 (the JAX
# package on the CPU, 8 cores): 6.02 / 3.05 / 2.97 / 2.96 px at steps
# 250 / 500 / 750 / 1000.
HAND_JAX_PX = 2.96
HAND_TOOL_PX = 4.0       # the trainer's own success bound
FIXTURE_BATCH = 16       # the pose and face fixture trainers' batch
RESUME_FRAMES = 24       # SLAM resumed mid-stream: the sweep's first frames at 640x480
RESUME_CUT = 12          # frames before the checkpoint
RESUME_TOL = 1e-4        # m and rotation entries: the resumed poses against the uninterrupted run's


MULTICHIP_RUNS = (("nccl", "cuda", 1), ("gloo", "cuda", 2), ("gloo", "cuda", 4), ("gloo", "cpu", 2))
MULTICHIP_STEPS = ("icp", "ba", "pose_graph", "relaxer", "train", "map_odometry")
MULTICHIP_HOST_CORES = 8     # the card's host: a fleet's ranks share its cores (torch threads a rank)
MULTICHIP_TRANSFORM_TOL = 1e-4  # the card's fleet against the CPU's: transforms, poses and landmarks


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


def device_events(prof):
    """(name, us) of each device event of a finished ``torch.profiler`` run,
    read from its kineto results: the events and durations that
    ``prof.events()`` gives, without building its tree of host events,
    which takes tens of seconds for a few hundred thousand of them."""
    from torch.autograd import DeviceType

    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()]


def profile_launches(fn, calls=20):
    """{kernel: mean device us per launch} over ``calls`` eager calls, by
    torch.profiler (a process that profiled before may drop events, so
    only per-launch means are kept)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for event, us in device_events(prof):
        m = re.search(r"[a-z][a-z_]*_kernel", event)
        name = m.group(0) if m else event[:40]
        total[name] = total.get(name, 0.0) + us
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
    for b, n, k in K1_EXAMPLES:
        plan = launch_plan(b, n, k, sms)
        print(f"K1 launch plan at B={b} N={n} K={k} on {sms} SMs (an example's): {plan}")
        require(plan.warps_per_sm >= K1_MIN_WARPS_PER_SM,
                f"K1 launches under {K1_MIN_WARPS_PER_SM} warps an SM at {(b, n, k)}")
    # The surface frame's shape is exempt: at K=512 there are 4 hypothesis
    # blocks, and one chunk a split (the plan's floor) gives 32 splits, so
    # 128 blocks on 132 SMs, 7.76 warps an SM. Raising it needs another
    # tiling of K1 (a redesign), not another plan.
    b, n, k = K1_SURFACE
    plan = launch_plan(b, n, k, sms)
    print(f"K1 launch plan at B={b} N={n} K={k} on {sms} SMs: {plan} (exempt from the "
          f"{K1_MIN_WARPS_PER_SM} warps an SM: one chunk a split is the plan's floor)")
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
    for shape, what in ((K1_SURFACE, "surface frame"), *((sh, "example") for sh in K1_EXAMPLES)):
        b, n, k = shape
        pts, mask, hyp = kernel_inputs(b, n, k, False, device, seed=1)
        times[shape] = timed(f"K1 ransac_score (B={b}, N={n}, K={k}, {what})",
                             lambda: ransac_score(pts, mask, hyp, TAU),
                             lambda: ransac_score_reference(pts, mask, hyp, TAU),
                             lambda: (9 * b * n * k, nbytes(pts, mask, hyp) + 4 * b * k),
                             plain_iters=20)
        floor = k1_floor_ms(b, n, k, sm_count(device.index), clock)
        times[shape]["floor_ms"] = floor
        print(f"  K1 issue-rate floor at {clock / 1e6:.0f} MHz: {floor:.5f} ms, device share of floor "
              f"{floor / times[shape]['device_ms']:.3f}")
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


def crossover_cases(device):
    """The kernel's arguments at the benchmark's nearest-neighbour crossover
    sizes (``headline.NN_SIZES``), on its own clouds (``nn_crossover.clouds``),
    the queries sorted into cell order as its warm and cold calls hand them
    to the kernel. A list of ((queries, map points), (args, overflow))."""
    from perception_tpu_torch.bench import headline, nn_crossover
    from perception_tpu_torch.ops import voxelhash

    cases = []
    for nq, m, ref, q in nn_crossover.clouds(headline.NN_SIZES):
        vh = voxelhash.build(torch.from_numpy(ref).to(device), torch.ones(m, dtype=torch.bool, device=device),
                             nn_crossover.RADIUS)
        q_sorted, _ = voxelhash.sort_by_cell(vh, torch.from_numpy(q).to(device))
        cases.append(((nq, m), voxelhash.kernel_args(vh, q_sorted)))
    return cases


def check_k3(device):
    """K3+K4 against its plain version: torch.equal on idx and d2; returns max |diff| of d2."""
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query, voxelhash_query_reference

    cases = [((m, nq, order, all_masked), k3_case(m, nq, order, all_masked, device))
             for m, nq, order, all_masked in K3_CASES]
    cases += [((m, nq, "crossover", False), case) for (nq, m), case in crossover_cases(device)]
    worst = 0.0
    for (m, nq, order, all_masked), (args, overflow) in cases:
        idx, d2 = voxelhash_query(*args)
        torch.cuda.synchronize()
        ridx, rd2 = voxelhash_query_reference(*args)
        equal = torch.equal(idx, ridx) and torch.equal(d2, rd2)
        table, _, _, nchunk, tile = args[:5]
        print(f"K3+K4 voxelhash_query map={m} (Npad {table.shape[0]}) queries={nq} {order} "
              f"all_masked={all_masked}: equal {equal}, tile {tile}, chunks max {int(nchunk.max())}, "
              f"overflow {float(overflow):.3f}, found {float((rd2[:nq] <= 0.06 ** 2).float().mean()):.3f}")
        require(equal, f"K3+K4 != plain version at {(m, nq, order, all_masked)}")
        require(order != "caller" or float(overflow) > 0, "unsorted queries did not overflow any tile")
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
    cases = [((m, nq), f"map {m}, {nq} sorted queries", k3_case(m, nq, "sorted", False, device, seed=1)[0])
             for m, nq in ((32768, 2048), (65536, 4096))]
    cases += [(("crossover", nq, m), f"NN crossover {nq} queries, {m} map points", args)
              for (nq, m), (args, _) in crossover_cases(device)]
    for key, label, args in cases:
        table, queries, start, nchunk, tile, R, rblk = args
        plan = launch_plan(queries.shape[0], tile, R, rblk, sm_count(device.index))
        print(f"K3+K4 launch plan at {queries.shape[0]} queries, tile {tile}, R {R}, rblk {rblk}: {plan}")
        require(plan.blocks >= 2 * sm_count(device.index), f"K3+K4 launches under 2 blocks per SM at {key}")
        live = {}

        def work():
            # Read after the timing window from the timed call's chunk counts:
            # the rows each tile's range holds, 9 operations a (query, row)
            # pair (3 subtracts, 3 multiplies, 2 adds, the compare).
            rows = torch.minimum(torch.clamp(nchunk.long() * rblk, max=R), table.shape[0] - start.long())
            live.update(pairs=int(rows.sum()) * tile, pieces=int(torch.ceil(rows / plan.piece_rows).sum()))
            return 9 * live["pairs"], nbytes(table, queries, start, nchunk) + 8 * queries.shape[0]

        times[key] = timed(f"K3+K4 voxelhash_query ({label})",
                           lambda: voxelhash_query(*args), lambda: voxelhash_query_reference(*args), work)
        print(f"  K3+K4 work: {live['pairs']} pairs, live pieces {live['pieces']} of {plan.blocks} blocks")
    return times


def translation_errors(res, gts):
    return np.linalg.norm(res.pose[..., :3, 3].cpu().numpy() - gts[:, :3, 3], axis=-1)


def run_slice(device):
    """Drive the main path on the card and check it; returns the K1
    launches of its counted B=1 and B=8 calls."""
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
    return launches


def reset_launches():
    for w in wrappers().values():
        w.launches = 0
        w.launches_by_shape.clear()


def read_launches():
    return {name: w.launches for name, w in wrappers().items()}


def read_launch_shapes():
    """Each wrapper's launches by the shape it launched at: K1 (B, N, K),
    K2 (R, Np, Mp), K3+K4 (padded queries, table rows)."""
    return {name: dict(w.launches_by_shape) for name, w in wrappers().items()}


def slam_scene(frames=SLAM_FRAMES):
    """The SLAM bench's 640x480 camera and the textured room along
    ``sweep_trajectory(n=300)``, rendered once (``slam_bench.rendered_sequence``,
    which the benchmark's SLAM rows reuse), its first ``frames`` poses:
    (camera, gt (frames, 4, 4), grays, depths (frames, H, W))."""
    from perception_tpu_torch.bench.slam_bench import rendered_sequence

    camera, gt, grays, depths = rendered_sequence(SLAM_FRAMES, 640, 480)
    return camera, gt[:frames], grays[:frames], depths[:frames]


def odometry_configs():
    """The default keyframe mode (op graph, then K2) and the SLAM bench's
    map-fusion settings (benchmarks/slam_bench.py) at map_budget 32768
    (shortlist, then the voxel hash)."""
    from perception_tpu_torch.bench.slam_bench import BENCH_ODOM
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


def state_to(state, device):
    """A state of NamedTuples of tensors on ``device``."""
    return type(state)(*(state_to(x, device) if isinstance(x, tuple) else x.to(device) for x in state))


def first_shortlist(state, depth, camera, cfg):
    """The candidate indices of the first shortlist build in one map-mode
    ``odometry_step`` from ``state`` on ``depth`` (on their device)."""
    from perception_tpu_torch.models.slam import odometry as odo

    built, real = [], odo._build_shortlist

    def spy(*args):
        out = real(*args)
        built.append(out[0])
        return out

    odo._build_shortlist = spy
    try:
        odo.odometry_step(state, depth, camera, cfg)
    finally:
        odo._build_shortlist = real
    return built[0]


def run_odometry_paths(device, scene):
    """Drive run_odometry at 640x480 over the scene's first ODO_FRAMES
    frames under the four configurations and check each, then the odometry
    benchmark (``bench/odometry_bench.run``), which times keyframe mode on
    the op graph and on K2; returns (kernel launches of the counted runs,
    the benchmark's K2 launches by shape, frames/s)."""
    from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, run_odometry
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
        if cfg.fused_gn == "on" or cfg.map_budget > 0:
            cpu_poses, _ = run_odometry(camera, torch.from_numpy(depths_np[:CPU_FRAMES]), cfg)
            cpu = torch.stack(cpu_poses)
            step = (cpu - est[:CPU_FRAMES]).abs().amax(dim=(1, 2))
            dt = float((cpu[:, :3, 3] - est[:CPU_FRAMES, :3, 3]).norm(dim=-1).max())
            dr = float((cpu[:, :3, :3] - est[:CPU_FRAMES, :3, :3]).abs().max())
            print(f"odometry [{name}] cuda vs cpu, first {CPU_FRAMES} frames: translation diff max "
                  f"{dt * 1e3:.6f} mm, rotation entry diff max {dr:.3e}, pose entry diff by frame "
                  f"{[f'{float(d):.2e}' for d in step]}")
            require(dt <= 1e-3, f"{name}: CUDA and CPU poses differ by more than 1 mm")
        if cfg.map_budget > 0 and cfg.map_nn == "auto":
            # The shortlist from the same state and frame: its distances and
            # top-k are formed in a fixed order, so the card picks the CPU's.
            state = init_state(camera, torch.from_numpy(depths_np[0]), cfg)
            got = first_shortlist(state_to(state, device), depths[1], camera, cfg).cpu()
            want = first_shortlist(state, torch.from_numpy(depths_np[1]), camera, cfg)
            rows = int((got != want).any(dim=1).sum())
            print(f"odometry [{name}] first shortlist build, cuda vs cpu from the same state: {tuple(got.shape)} "
                  f"candidates, rows that differ {rows}")
            require(rows == 0, f"{name}: the card's shortlist differs from the CPU's")

        if cfg.map_budget == 0:
            continue  # keyframe mode is timed by the odometry benchmark below
        fps, runs = frames_per_s(lambda: run_odometry(camera, depths, cfg), ODO_FRAMES)
        rates[name] = fps
        print(f"odometry [{name}]: {fps:.2f} frames/s (passes {[round(r, 2) for r in runs]})")

    # Keyframe mode on the op graph and on K2 at the benchmark's two budget
    # pairs (its own room sweep): K2 once a GN iteration, counted by shape;
    # the two modes find the same neighbours, so their last poses agree.
    reset_launches()
    bench = odometry_bench.run(device=device)
    torch.cuda.synchronize()
    k2 = read_launch_shapes()["icp_gn"]
    print(f"odometry_bench.run: {json.dumps({k: v for k, v in bench.items() if k != 'final_pose'})}; "
          f"K2 launches by shape {k2}")
    steps = (1 + odometry_bench.TIMED_FRAMES) * OdometryConfig().icp_iterations
    want = {(1, p, k): steps for p, k in odometry_bench.BUDGETS}
    require(k2 == want, f"odometry_bench: K2 launches {k2}, expected {want}")
    for p, k in odometry_bench.BUDGETS:
        off, on = (torch.tensor(bench["final_pose"][f"{p}x{k} {mode}"]) for mode in odometry_bench.MODES)
        print(f"odometry_bench {p}x{k}: last pose, K2 against the op graph, max entry diff "
              f"{float((on - off).abs().max()):.3e}")
        require(torch.allclose(on, off, **K2_TOL), f"odometry_bench {p}x{k}: K2's pose differs from the op graph's")
    return launches, k2, rates


def frames_per_s(fn, frames, passes=3, warm=True):
    """Median frames/s of ``passes`` calls of ``fn`` (``frames`` frames a
    call) by the host clock, after a warm-up call unless ``warm`` is off."""
    if warm:
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
    from perception_tpu_torch.bench.slam_bench import bench_config

    return {
        "slam keyframe+BA K2": bench_config(fused_gn="on"),
        "slam keyframe no-BA K2": bench_config(enable_ba=False, fused_gn="on"),
        "slam map 32768 hash": bench_config(map_budget=32768, map_nn="hash"),
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
              f"observations {s['observations']}, launches {counts}, counted run {first_s:.1f} s "
              f"({(SLAM_FRAMES - 1) / first_s:.2f} frames/s with its first steps)")
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
    return launches


def device_profile(fn, calls):
    """torch.profiler over ``calls`` calls of ``fn``: (busy share = device
    time of every kernel, copy and set over the wall time, which the
    profiler inflates; wall ms a call; {device op name: ms a call}; the
    number of device ops)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, ops, by_name = 0.0, 0, {}
    for name, us in device_events(prof):
        busy += us
        ops += 1
        by_name[name] = by_name.get(name, 0.0) + us
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


def objects_scene():
    """``bench/objects_bench``'s setting on the CPU (its ``scene`` and
    ``bench_config``: the full D435 camera at 640x480, the clutter scene at
    seed 3, ObjectConfig(cluster_min_size=40, size_gate=250)), its four
    captured class templates and a 0.3 x 0.3 x 0.02 m plate that matches no
    object, and the RANSAC triplets that the card and the CPU share."""
    from perception_tpu_torch.bench.clutter_scene import captured_template
    from perception_tpu_torch.io.templates import box_surface_template
    from perception_tpu_torch.models.objects import working_set
    from perception_tpu_torch.ops.ransac import _sample_indices

    camera, poses, depth = objects_bench.scene()
    pts_cpu, mask_cpu = camera.backproject_depth(torch.from_numpy(depth))
    templates = {name: captured_template(name, camera) for name in OBJ_CLASSES}
    templates["plate"] = box_surface_template((0.3, 0.3, 0.02), 0.003)
    cfg = objects_bench.bench_config()
    _, dm, _ = working_set(pts_cpu, mask_cpu, cfg)
    idx = _sample_indices(torch.Generator().manual_seed(11), dm, cfg.ransac_hypotheses)
    return dict(camera=camera, poses=poses, pts_cpu=pts_cpu, mask_cpu=mask_cpu, templates=templates, cfg=cfg, idx=idx)


def start_eraser_cpu(scene):
    """Start the eraser's ERASER_CALLS CPU calls of ``detect_object`` (the
    scene's triplets) in a worker process on ERASER_CPU_THREADS threads, to
    run beside the card's phases; ``eraser_spread`` collects them."""
    t = scene["templates"]["eraser"]
    host_in = (scene["pts_cpu"], scene["mask_cpu"], torch.from_numpy(t), torch.ones(len(t), dtype=torch.bool))
    pool = multiprocessing.get_context("spawn").Pool(1)
    job = pool.apply_async(eraser_cpu_poses, (host_in, scene["idx"], scene["cfg"], ERASER_CALLS, ERASER_CPU_THREADS))
    return pool, job


def run_objects(device, scene, eraser_cpu):
    """benchmarks/objects_bench.py's setting (``objects_scene``) through
    ``detect_object``. Returns the K1 launches of the counted calls and
    the eraser's repeated calls for ``eraser_spread``."""
    from perception_tpu_torch.models.objects import detect_object
    from perception_tpu_torch.ops import icp, ransac

    camera, poses, pts_cpu, mask_cpu, templates, cfg, idx = (
        scene[k] for k in ("camera", "poses", "pts_cpu", "mask_cpu", "templates", "cfg", "idx"))
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

    # The eraser ERASER_CALLS times on the same triplets on the card; its CPU
    # calls run in the worker process that start_eraser_cpu started.
    t0 = time.perf_counter()
    card = [detect_object(pts, mask, *on_card["eraser"], None, cfg, indices=idx).pose.cpu().numpy().astype(np.float64)
            for _ in range(ERASER_CALLS)]
    pool, job = eraser_cpu
    pending = dict(pool=pool, job=job, card=card, card_s=time.perf_counter() - t0, template=templates["eraser"],
                   gt=poses["eraser"])

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

    # ms a call per class: the benchmark's run (a warm-up and REPS timed
    # calls a class, one K1 launch a call, counted by shape); the plate,
    # which the benchmark does not run, timed here the same way.
    reset_launches()
    bench = objects_bench.run(device=device)
    torch.cuda.synchronize()
    bench_k1 = read_launch_shapes()["ransac_score"]
    print(f"objects_bench.run: {json.dumps(bench)}; K1 launches by shape {bench_k1}")
    want = len(OBJ_CLASSES) * (1 + objects_bench.REPS)
    require(list(bench_k1.values()) == [want] and read_launches()["icp_gn"] == read_launches()["voxelhash_query"] == 0,
            f"objects_bench: K1 launches {bench_k1}, expected {want} at one shape and no other kernel")
    require(bench["classes"] == len(OBJ_CLASSES) and set(bench["per_class_ms"]) == set(OBJ_CLASSES),
            "objects_bench: classes")
    runs = []
    detect_object(pts, mask, *on_card["plate"], gen, cfg)
    torch.cuda.synchronize()
    for _ in range(objects_bench.REPS):
        t0 = time.perf_counter()
        detect_object(pts, mask, *on_card["plate"], gen, cfg)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    print(f"objects [plate]: {statistics.median(runs):.2f} ms per call (calls {[round(r, 2) for r in runs]})")
    from perception_tpu_torch.models import objects

    for name in ("eraser", "clamp"):
        print(f"objects [{name}] stage ms (synchronized): " + str(stage_ms(
            lambda: detect_object(pts, mask, *on_card[name], gen, cfg),
            {"front end": [(objects, "front_end")], "icp": [(objects, "icp_batched")]})))
    busy, wall, by_name, _ = device_profile(lambda: detect_object(pts, mask, *on_card["eraser"], gen, cfg), 2)
    print(f"objects [eraser] profile (torch.profiler, 2 calls): device busy share {busy:.4f}, wall {wall:.2f} ms "
          f"a call, top device ms a call {top_ms(by_name)}")
    return counts["ransac_score"], sum(bench_k1.values()), pending


def eraser_cpu_poses(host_in, idx, cfg, calls, threads):
    """``detect_object`` of the eraser ``calls`` times on the CPU with the
    triplets ``idx`` (a worker process's job, on ``threads`` threads):
    (poses as float64 arrays, seconds)."""
    from perception_tpu_torch.models.objects import detect_object

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    poses = [detect_object(*host_in, None, cfg, indices=idx).pose.numpy().astype(np.float64) for _ in range(calls)]
    return poses, time.perf_counter() - t0


def eraser_spread(pool, job, card, card_s, template, gt):
    """The eraser's repeated calls on the card and on the CPU (same
    triplets): the spread of the chamfer on each, and of each card call's
    translation from the first CPU call's. Fails where a card call lies
    over 1 mm from the CPU, or where two card calls differ."""
    try:
        cpu, cpu_s = job.get(timeout=900)
    finally:
        pool.close()
        pool.join()
    for dev, out, secs in (("cuda", card, card_s), ("cpu", cpu, cpu_s)):
        ch = [chamfer_cm(template, pose, gt) for pose in out]
        print(f"objects [eraser] x {len(out)} on {dev} (same triplets): chamfer min {min(ch):.6f} max {max(ch):.6f} "
              f"cm, {len(set(np.round(ch, 9)))} distinct values ({secs:.1f} s)")
    gaps = np.linalg.norm(np.stack([p[:3, 3] for p in card]) - cpu[0][:3, 3], axis=-1) * 1e3
    print(f"objects [eraser] card - cpu translation over {len(card)} card calls: min {gaps.min():.6f} max "
          f"{gaps.max():.6f} mm, values {sorted(set(np.round(gaps, 6).tolist()))}; cpu calls all equal "
          f"{all(np.array_equal(p, cpu[0]) for p in cpu)}")
    require(gaps.max() <= 1.0, "objects eraser: a card call lies over 1 mm from the CPU's")
    # The centroid sums are fixed-order (ops/points.segment_sum): every card
    # call gives the same pose, where float atomics gave two modes.
    require(all(np.array_equal(p, card[0]) for p in card), "objects eraser: the card's calls differ")


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


def run_tracker(device):
    """The streaming tracker through ``track_step_from_depth`` on the
    300-frame sweep's first TRACK_CHECK_FRAMES frames: the card against the CPU on the same
    triplets, one host read of ``steady`` a frame, stage ms and the busy
    share. Its 300-frame run, gated, is the benchmark's tracker row
    (``run_bench``)."""
    from perception_tpu_torch.bench import tracking_bench
    from perception_tpu_torch.bench.tracking_scene import camera_trajectory, render_depth_cuboids
    from perception_tpu_torch.models import object_tracking
    from perception_tpu_torch.models.cuboid import decimate
    from perception_tpu_torch.models.object_tracking import init_tracks, slot_template_normals, track_step_from_depth
    from perception_tpu_torch.models.objects import working_set
    from perception_tpu_torch.ops import ransac
    from perception_tpu_torch.ops.ransac import _sample_indices

    t0 = time.perf_counter()
    camera = tracking_bench.bench_camera()
    templates_np, tmasks_np = tracking_bench.bench_templates()
    traj = camera_trajectory(TRACK_FRAMES)[:TRACK_CHECK_FRAMES]
    depths_np = np.stack([render_depth_cuboids(camera, T, seed=i)[0] for i, T in enumerate(traj)])
    print(f"tracking scene: the first {TRACK_CHECK_FRAMES} of {TRACK_FRAMES} frames {camera.width}x{camera.height}, "
          f"fx {camera.fx:.1f}, rendered in {time.perf_counter() - t0:.1f} s")
    cfg = tracking_bench.bench_config()
    on = {}
    for dev in ("cpu", device):
        t, m = torch.from_numpy(templates_np).to(dev), torch.from_numpy(tmasks_np).to(dev)
        on[str(dev)] = (t, m, slot_template_normals(t, m))
    depths = torch.from_numpy(depths_np).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step(slots, depth, dev=device, **kw):
        t, m, tn = on[str(dev)]
        return track_step_from_depth(slots, depth, camera, t, m, kw.pop("gen", gen), cfg, template_normals=tn, **kw)

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

    frames = itertools.cycle(range(TRACK_SYNC_FRAMES, TRACK_CHECK_FRAMES))
    holder = [slots]

    def one():
        holder[0], _ = step(holder[0], depths[next(frames)])

    print("tracker stage ms (synchronized, one steady frame): " + str(stage_ms(
        one, {"front end": [(object_tracking, "_front_end")], "icp": [(object_tracking, "icp_point_to_plane")]})))
    busy, wall, by_name, _ = device_profile(one, 10)
    print(f"tracker profile (torch.profiler, 10 steady frames): device busy share {busy:.4f}, wall {wall:.2f} ms "
          f"a frame, top device ms a frame {top_ms(by_name)}")


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


def sync_ms(fn, reps=3):
    """(median, min, max) host-clock ms of one synchronized ``fn()`` call
    over ``reps`` calls after a warm-up (for calls that read the card)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
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
    3. Times: ``bench/pose_bench.run`` at its full sizes (``extract_people``
       a frame at B=1 and B=8, ``resize_and_merge`` (26, 46, 46) ->
       368x368, ``nms_heatmap`` (25, 368, 368) at K=32; host clock), then
       by CUDA events the CNN alone and the decode, the decode's stages,
       the device busy share by torch.profiler, and the CNN's bound (f32
       operations at 67 TFLOP/s).
    """
    import copy

    from perception_tpu_torch.models import hand_fixture as HF
    from perception_tpu_torch.models import pose, pose_fixture as PF
    from perception_tpu_torch.models.hand_data import hand_box
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
    # extract_people at B=1 and B=8, resize_and_merge and nms_heatmap at the
    # reference's stage shapes: the benchmark's run, on its own weights.
    bench = pose_bench.run(device=device)
    print(f"pose_bench.run: {json.dumps(bench)}")
    require(bench["net_hw"] == list(WIDE_HW) and bench["batch"] == WIDE_BATCH
            and all(bench[k] > 0 for k in ("resize_merge_ms", "nms_ms", "extract_ms_batch1",
                                           "extract_ms_per_frame_batch")), "pose_bench: sizes or times")
    t_c1 = event_ms(lambda: wide(nchw[1]))
    t_c8 = event_ms(lambda: wide(nchw[WIDE_BATCH]))
    t_dec = event_ms(lambda: pose.decode_people(*unit, pairs, num_parts=len(parts), paf_stride=8.0), calls=20)
    print(f"full width {topology} {WIDE_HW} times (CUDA events, median of {TIMED_REPS} runs of {TIMED_CALLS}):")
    print(f"  CNN alone B=1: {fmt_ms(t_c1)}; B={WIDE_BATCH}: {fmt_ms(t_c8, WIDE_BATCH)} a frame")
    print(f"  CNN bound: {ops / 1e9:.3f} GFLOP a frame (2 per multiply-add) at {PEAK_F32_OPS / 1e12:.0f} TFLOP/s "
          f"= {bound_ms:.4f} ms a frame; share of bound B=1 {bound_ms / t_c1[0]:.4f}, "
          f"B={WIDE_BATCH} {bound_ms * WIDE_BATCH / t_c8[0]:.4f}")
    print(f"  decode_people (maps scaled to unit maximum): {fmt_ms(t_dec)}")
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


def face_scenes(seed=FACE_SEED, n=FACE_SCENES):
    """The single-face scenes: ``n`` of ``sample_face`` at the fixture's
    128x128 and fx from numpy's default_rng(``seed``), each rendered with
    noise from the same generator: a list of (FaceScene, gray (H, W))."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face_data import render_face, sample_face

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        scene = sample_face(rng, FF.FIXTURE_HW, FF.FIXTURE_FX, FF.FIXTURE_FX)
        out.append((scene, render_face(scene, FF.FIXTURE_HW, rng=rng)))
    return out


def face_chain(nets, gray, fx, cx, cy):
    """One face from pixels alone (``tests/test_face_e2e.py``'s pipeline):
    the trained detector's best box -> 96-pixel crop -> landmarks ->
    head-pose PnP -> gaze -> AU intensities. {name: tensor}."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face import gaze_from_landmarks, head_pose_pnp, normalize_landmarks
    from perception_tpu_torch.models.hand import crop_image

    det = FF.detect_with_net(nets["det"], gray)
    box = det.boxes[0]
    patch = crop_image(gray, box, FF.FIXTURE_CROP) / 255.0
    uv, m, _ = FF.landmarks_from_crop(nets["landmark"], patch, box)
    T, px_err = head_pose_pnp(uv, m, fx, fx, cx, cy)
    gaze_r, gaze_l = gaze_from_landmarks(uv, T, fx, fx, cx, cy)
    with torch.no_grad():
        inten, _ = nets["au"](normalize_landmarks(uv, m))
    return {"found": det.mask[0], "box": box, "landmarks": uv, "landmark_mask": m, "head_pose": T,
            "reproj_px": px_err, "gaze": torch.stack([gaze_r, gaze_l]), "au_intensities": inten}


def face_gates(scene, out):
    """``tests/test_face_e2e.py``'s checks of one scene: (detector IoU
    with the true box, mean landmark error px, head pose within 3 cm and
    0.15 rad, gaze rays unit-length with z < 0, AU02 gate = brow raised)."""
    from perception_tpu_torch.models.face import au_gated_pose_mask, iou
    from perception_tpu_torch.models.face_data import crop_box_from_landmarks

    out = {k: v.cpu() for k, v in out.items()}
    box_iou = float(iou(out["box"], torch.from_numpy(crop_box_from_landmarks(scene.landmarks2d))))
    m = out["landmark_mask"].numpy()
    lm_err = float(np.linalg.norm(out["landmarks"].numpy() - scene.landmarks2d, axis=-1)[m].mean())
    T = out["head_pose"].numpy()
    t_err = float(np.linalg.norm(T[:3, 3] - scene.pose[:3, 3]))
    ang = float(np.arccos(np.clip((np.trace(T[:3, :3] @ scene.pose[:3, :3].T) - 1) / 2, -1, 1)))
    g = out["gaze"].numpy()
    gaze_ok = bool(np.all(np.abs(np.linalg.norm(g, axis=-1) - 1.0) < 1e-4) and np.all(g[:, 2] < 0))
    gate_ok = bool(au_gated_pose_mask(out["au_intensities"])) == (float(scene.au02) > 0.4)
    return box_iou, lm_err, t_err < 0.03 and ang < 0.15, gaze_ok, gate_ok


def three_faces(seed, hw=MULTI_HW, fx=None, offsets=MULTI_OFFSETS, z=MULTI_Z, n=1, au02=None):
    """``tests/test_face_multi.py``'s and ``facade_bench.py``'s scene from
    numpy's default_rng(seed): faces by ``sample_face_at`` at ``offsets``
    (metres) and depth ``z`` (brow raise ``au02[i]`` where given), then
    ``n`` renders with fresh noise. (scenes, grays (n, H, W) in [0, 255])."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face_data import render_faces, sample_face_at, stack_scenes

    fx = FF.FIXTURE_FX if fx is None else fx
    rng = np.random.default_rng(seed)
    scenes = [sample_face_at(rng, hw, fx, fx, o, z, au02=None if au02 is None else au02[i])
              for i, o in enumerate(offsets)]
    stacked = stack_scenes(scenes)
    return scenes, np.stack([render_faces(stacked, hw, rng=rng) for _ in range(n)])


def match_faces(scenes, out):
    """Each active slot's true face (best IoU): [(slot, face, IoU, landmark
    error px, translation error m)]."""
    from perception_tpu_torch.models.face import iou
    from perception_tpu_torch.models.face_data import crop_box_from_landmarks

    out = {k: v.cpu() for k, v in out.items()}
    gt = torch.from_numpy(np.stack([crop_box_from_landmarks(s.landmarks2d) for s in scenes]))
    rows = []
    for j in torch.nonzero(out["mask"]).flatten().tolist():
        ious = iou(out["boxes"][j][None], gt)
        k = int(torch.argmax(ious))
        m = out["landmark_mask"][j].numpy()
        err = float(np.linalg.norm(out["landmarks"][j].numpy() - scenes[k].landmarks2d, axis=-1)[m].mean())
        t_err = float(np.linalg.norm(out["head_pose"][j].numpy()[:3, 3] - scenes[k].pose[:3, 3]))
        rows.append((j, k, float(ious[k]), err, t_err))
    return rows


@contextlib.contextmanager
def face_landmark_maps():
    """Record, on the CPU, each (heatmaps, crop boxes) pair that the face
    chain decodes (``face_fixture.decode_landmarks``) while the block runs."""
    from perception_tpu_torch.models import face_fixture as FF

    seen, real = [], FF.decode_landmarks

    def spy(heatmaps, crop_box, *args, **kwargs):
        seen.append((heatmaps.detach().cpu(), crop_box.detach().cpu()))
        return real(heatmaps, crop_box, *args, **kwargs)

    FF.decode_landmarks = spy
    try:
        yield seen
    finally:
        FF.decode_landmarks = real


def tied_peaks(card_maps, cpu_maps):
    """(tied (..., C) bool, the maps' max abs difference): a landmark is
    tied where the card's and the CPU's heatmaps peak in different cells
    whose values on the CPU's map lie within twice the maps' difference,
    so that rounding alone orders them."""
    diff = float((card_maps - cpu_maps).abs().max())
    a, b = card_maps.flatten(-2).argmax(-1), cpu_maps.flatten(-2).argmax(-1)
    flat = cpu_maps.flatten(-2)
    gap = flat.gather(-1, b[..., None])[..., 0] - flat.gather(-1, a[..., None])[..., 0]
    return (a != b) & (gap <= 2.0 * diff), diff


def compare_faces(label, got, want, lm_tol=FACE_LM_TOL, pose_tol=FACE_POSE_TOL, maps=None):
    """Hold multi-face outputs ``got`` (any device) to ``want`` (CPU): the
    same slots, landmark masks and gates; boxes and landmarks within
    ``lm_tol`` px, head poses within ``pose_tol``.

    ``maps`` = (card's, CPU's) (heatmaps, crop boxes) of the landmark
    decode, from ``face_landmark_maps``: the heatmaps are then held within
    FACE_MAP_TOL, and a landmark whose peak is tied (``tied_peaks``) is
    held instead to the CPU's decode of the card's heatmaps, within
    ``lm_tol``: the separable peak refinement reads the winning cell's row
    and column, so two cells that differ by rounding move it by a part of
    a cell."""
    from perception_tpu_torch.models.face import decode_landmarks

    got = {k: v.cpu() for k, v in got.items()}
    same = all(torch.equal(got[k], want[k]) for k in ("mask", "landmark_mask", "pose_gate", "ok"))
    box = float((got["boxes"] - want["boxes"]).abs().max())
    lm_diff = (got["landmarks"] - want["landmarks"]).abs().amax(-1)
    tied, note, held = torch.zeros_like(lm_diff, dtype=torch.bool), "", True
    if maps is not None:
        (card_hm, card_box), (cpu_hm, _) = maps
        tied, map_diff = tied_peaks(card_hm, cpu_hm)
        redecoded = float((decode_landmarks(card_hm, card_box)[0] - got["landmarks"]).abs().max())
        tied_lm = float(lm_diff[tied].max()) if bool(tied.any()) else 0.0
        note = (f"; heatmaps max diff {map_diff:.3e} (limit {FACE_MAP_TOL}), {int(tied.sum())} tied peaks "
                f"({tied_lm:.3e} px apart), the card's heatmaps decoded on the CPU within {redecoded:.3e} px")
        held = map_diff <= FACE_MAP_TOL and redecoded <= lm_tol
    lm = float(lm_diff[~tied].max())
    pose = float((got["head_pose"] - want["head_pose"]).abs().max())
    print(f"{label}: faces {int(want['mask'].sum())}, same slots, masks and gates {same}, boxes max diff {box:.3e} px, "
          f"landmarks {lm:.3e} px, head poses {pose:.3e}{note}")
    require(same and held and box <= lm_tol and lm <= lm_tol and pose <= pose_tol,
            f"{label}: card and CPU disagree beyond {lm_tol} px / {pose_tol}")


def run_face(device):
    """The face family on its own.

    1. The single-face chain (``face_chain``) on FACE_SCENES scenes:
       ``tests/test_face_e2e.py``'s gates (detector IoU > 0.5 on every
       scene, mean landmark error < 4 px, head pose within 3 cm and 0.15
       rad on all but one, gaze rays unit-length toward the camera, the
       AU02 gate right on all but one), the card's landmarks within
       FACE_LM_TOL px of the CPU's and its gates equal; no host sync.
    2. ``multi_face_step`` on ``tests/test_face_multi.py``'s scene
       (256x256, three faces at MULTI_OFFSETS, z = MULTI_Z, four slots):
       3 slots, each face once at IoU > 0.5, landmark error < 5 px and
       translation < 5 cm a face; two throttled frames (``detect`` False)
       keeping the 3 faces with ``ok == mask``; the AU02 gate firing on
       face 0 alone when only its brows are raised; card against CPU.
    """
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models import face_multi as FM

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    nets = {d: FF.load_fixture(d) for d in (device, cpu)}
    hw, fx = FF.FIXTURE_HW, FF.FIXTURE_FX
    cx, cy = hw[1] / 2.0, hw[0] / 2.0

    reset_launches()
    rows, diffs, same = [], [], True
    for i, (scene, img) in enumerate(face_scenes()):
        gray = {d: torch.from_numpy(img).to(d) for d in (device, cpu)}
        torch.cuda.synchronize()
        with recorded_syncs() as sites:
            card = face_chain(nets[device], gray[device], fx, cx, cy)
        torch.cuda.synchronize()
        if i == 0:
            require_syncs("single-face chain", sites, {})
        host = face_chain(nets[cpu], gray[cpu], fx, cx, cy)
        rows.append(face_gates(scene, card))
        same &= face_gates(scene, host)[2:] == rows[-1][2:] and torch.equal(card["landmark_mask"].cpu(),
                                                                            host["landmark_mask"])
        diffs.append(float((card["landmarks"].cpu() - host["landmarks"]).abs().max()))
    counts = read_launches()
    ious, errs, pose_ok, gaze_ok, gate_ok = zip(*rows)
    print(f"face path launches of K1-K4 (none on this path): {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the face path")
    print(f"single-face chain on {FACE_SCENES} scenes (seed {FACE_SEED}, {hw[1]}x{hw[0]}): detector IoU "
          f"{[round(v, 3) for v in ious]} (gate > 0.5 on every scene); landmark error {[round(v, 3) for v in errs]} px, "
          f"mean {np.mean(errs):.3f} (gate < 4); head pose within 3 cm and 0.15 rad on {sum(pose_ok)} (gate >= "
          f"{FACE_SCENES - 1}); gaze unit and toward the camera on {sum(gaze_ok)} (gate {FACE_SCENES}); AU02 gate "
          f"right on {sum(gate_ok)} (gate >= {FACE_SCENES - 1}); cuda vs cpu: landmarks max diff {max(diffs):.3e} px "
          f"(limit {FACE_LM_TOL}), gates and masks equal {same}")
    require(min(ious) > 0.5 and np.mean(errs) < 4.0 and sum(pose_ok) >= FACE_SCENES - 1
            and all(gaze_ok) and sum(gate_ok) >= FACE_SCENES - 1, "single-face chain: a gate missed")
    require(same and max(diffs) <= FACE_LM_TOL, "single-face chain: card and CPU disagree")

    # 2. Multi-face slots on the three-face scene.
    cx, cy = MULTI_HW[1] / 2.0, MULTI_HW[0] / 2.0
    scenes, img = three_faces(MULTI_SEED)
    gray = {d: torch.from_numpy(img[0]).to(d) for d in (device, cpu)}
    state = {d: FM.init_tracks(MULTI_SLOTS, d) for d in (device, cpu)}
    reset_launches()
    for frame, detect in enumerate((True, False, False)):
        out = {}
        for d in (device, cpu):
            torch.cuda.synchronize()
            with recorded_syncs() as sites:
                state[d], out[d] = FM.multi_face_step(nets[d], gray[d], state[d], fx, fx, cx, cy, detect)
            torch.cuda.synchronize()
            if d == device and frame < 2:
                require_syncs(f"multi_face_step (detect={detect})", sites, {})
        compare_faces(f"multi-face frame {frame} (detect={detect}) cuda vs cpu", out[device], out[cpu])
        card = {k: v.cpu() for k, v in out[device].items()}
        rows = match_faces(scenes, card)
        n_active = int(state[device].active.sum())
        print(f"multi-face frame {frame} (detect={detect}): {len(rows)} faces, {n_active} active slots; (slot, face, "
              f"IoU, landmark error px, translation error m) {[tuple(round(v, 4) for v in r) for r in rows]}; "
              f"ok == mask {torch.equal(card['ok'], card['mask'])}")
        require(len(rows) == 3 and n_active == 3 and sorted(r[1] for r in rows) == [0, 1, 2],
                f"multi-face frame {frame}: not three faces, each once")
        require(all(r[2] > 0.5 and r[3] < 5.0 and r[4] < 0.05 for r in rows),
                f"multi-face frame {frame}: IoU, landmark or translation gate missed")
        require(frame == 0 or torch.equal(card["ok"], card["mask"]), f"multi-face frame {frame}: a slot failed")
    scenes, img = three_faces(MULTI_SEED + 2, au02=[1.0, 0.05, 0.05])
    _, out = FM.multi_face_step(nets[device], torch.from_numpy(img[0]).to(device), FM.init_tracks(MULTI_SLOTS, device),
                                fx, fx, cx, cy, True)
    gate = out["pose_gate"].cpu()
    raised = sorted(k for j, k, *_ in match_faces(scenes, out) if bool(gate[j]))
    print(f"multi-face AU02 gate, brows raised on face 0 only: the gate fires on faces {raised} (want [0])")
    require(raised == [0], "multi-face: the AU02 gate is not per face")
    counts = read_launches()
    print(f"multi-face path launches of K1-K4: {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the multi-face path")

    # Times of the face chain on the card.
    one = torch.from_numpy(face_scenes(n=1)[0][1]).to(device)
    st = [FM.init_tracks(MULTI_SLOTS, device)]
    g3 = gray[device]

    def step(detect=True):
        st[0], _ = FM.multi_face_step(nets[device], g3, st[0], fx, fx, cx, cy, detect)

    t_chain = event_ms(lambda: face_chain(nets[device], one, FF.FIXTURE_FX, 64.0, 64.0))
    t_step = event_ms(step)
    t_thr = event_ms(lambda: step(False))
    crops = torch.rand((MULTI_SLOTS, 1, FF.FIXTURE_CROP, FF.FIXTURE_CROP), device=device)
    with torch.no_grad():
        t_lm = event_ms(lambda: nets[device]["landmark"](crops))
        t_det = event_ms(lambda: nets[device]["det"](g3[None, None] / 255.0))
    lm_ops = posenet_ops(nets[device]["landmark"], crops) * MULTI_SLOTS
    det_ops = posenet_ops(nets[device]["det"], g3[None, None])
    print(f"face times (CUDA events, median of {TIMED_REPS} runs of {TIMED_CALLS}): single-face chain {fmt_ms(t_chain)}; "
          f"multi_face_step {MULTI_HW[1]}x{MULTI_HW[0]}, {MULTI_SLOTS} slots: detect {fmt_ms(t_step)}, throttled "
          f"{fmt_ms(t_thr)}; landmark net on {MULTI_SLOTS} crops {fmt_ms(t_lm)} (bound {lm_ops / PEAK_F32_OPS * 1e3:.4f} "
          f"ms, {lm_ops / 1e9:.4f} GFLOP); detector net {fmt_ms(t_det)} (bound {det_ops / PEAK_F32_OPS * 1e3:.4f} ms, "
          f"{det_ops / 1e9:.4f} GFLOP)")
    busy, wall, by_name, n_ops = device_profile(step, 10)
    print(f"multi_face_step profile (torch.profiler, 10 calls): device busy share {busy:.4f}, wall {wall:.3f} ms a "
          f"call, {n_ops / 10:.0f} device ops a call, top device ms a call {top_ms(by_name)}")
    print(f"face phase: {time.perf_counter() - t_phase:.1f} s")


def rgb(grays):
    """Gray frames repeated to RGB, as ``facade_bench.py`` stages them."""
    return np.repeat(grays[..., None], 3, axis=-1)


def compare_datum(label, got, want, maps=None):
    """A card datum against the CPU's: people, faces (``maps`` as
    ``compare_faces`` takes them) and hands."""
    compare_people(f"{label} people", got.people, want.people)
    if want.faces is not None:
        compare_faces(f"{label} faces", got.faces, want.faces, maps=maps)
    if want.hands is not None:
        h = {k: v.cpu() for k, v in got.hands.items()}
        same = all(torch.equal(h[k], want.hands[k]) for k in ("box_valid", "landmark_mask"))
        d = max(float((h[k] - want.hands[k]).abs().max()) for k in ("boxes", "landmarks"))
        print(f"{label} hands: {int(want.hands['box_valid'].sum())} valid boxes, masks equal {same}, boxes and "
              f"landmarks max diff {d:.3e} px")
        require(same and d <= CHAIN_TOL, f"{label}: hands differ between card and CPU")


def facade_stage_ms(engine, frame):
    """One ``emplace_and_pop`` with a synchronize around its pose, face and
    hand steps."""
    from perception_tpu_torch import wrapper
    from perception_tpu_torch.models import hand_fixture

    return stage_ms(lambda: engine.emplace_and_pop(frame), {
        "pose": [(engine, "_pose")], "face": [(engine, "_face")], "hands": [(hand_fixture, "hands_from_pose")]})


def run_facade(device):
    """The Perception facade.

    1. ``benchmarks/facade_bench.py``'s setting: the MPI_15 pose fixture at
       128x128, 4 face slots, hands of the top 2 people, on FACADE_STAGED
       pre-staged 256x256 three-face frames: faces tracked (3) and carried
       over FACADE_FRAMES frames, stage ms, the busy share, host syncs of
       one ``emplace_and_pop`` (stated: none) and the card's first datum
       against the CPU's. Its timed pass is the benchmark's facade row
       (``run_bench``).
    2. Full width: BODY_25 PoseNet at 368x368 (``init_posenet``'s seeded
       weights), 4 face slots and hands of 2 people on 480x640 frames with
       three faces (fx scaled as the wrapper scales it): ms a frame by CUDA
       events, stage ms, the busy share, the card against the CPU on one
       frame.
    """
    import copy

    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.wrapper import Perception, WrapperStructFace, WrapperStructHand, WrapperStructPose

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    face, hand = WrapperStructFace(enabled=True, max_faces=MULTI_SLOTS), WrapperStructHand(enabled=True, top_n_people=2)
    frames = rgb(three_faces(FACADE_SEED, n=FACADE_STAGED)[1])
    staged = torch.from_numpy(frames).to(device)
    engines = {d: Perception(face=face, hand=hand, device=d) for d in (device, cpu)}
    reset_launches()
    with face_landmark_maps() as maps:
        first = engines[device].emplace_and_pop(staged[0], frame_index=0)
        want = engines[cpu].emplace_and_pop(frames[0], frame_index=0)
    compare_datum("facade 256x256 frame 0 cuda vs cpu", first, want, maps=maps)
    faces = int(first.faces["mask"].sum())
    print(f"facade 256x256: faces tracked {faces} (want 3)")
    require(faces == 3, "facade: not 3 faces tracked")
    torch.cuda.synchronize()
    with recorded_syncs() as sites:
        engines[device].emplace_and_pop(staged[1], frame_index=1)
    torch.cuda.synchronize()
    require_syncs("facade emplace_and_pop (no sinks)", sites, {})

    eng = engines[device]
    for k in range(2, FACADE_FRAMES + 2):
        last = eng.emplace_and_pop(staged[k % FACADE_STAGED], frame_index=k)
    counts = read_launches()
    print(f"facade path launches of K1-K4: {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the facade path")
    print(f"facade at facade_bench.py's setting (MPI_15 fixture 128x128, {MULTI_SLOTS} face slots, hands of 2 people, "
          f"256x256 frames): faces tracked {int(last.faces['mask'].sum())} after {FACADE_FRAMES + 2} frames")
    require(int(last.faces["mask"].sum()) == 3, "facade: the faces were not carried")
    print(f"facade 256x256 stage ms (synchronized): {facade_stage_ms(eng, staged[0])}")
    busy, wall, by_name, n_ops = device_profile(lambda: eng.emplace_and_pop(staged[0]), 10)
    print(f"facade 256x256 profile (torch.profiler, 10 frames): device busy share {busy:.4f}, wall {wall:.3f} ms a "
          f"frame, {n_ops / 10:.0f} device ops a frame, top device ms a frame {top_ms(by_name)}")

    # 2. Full width at the D435 colour resolution.
    fx = FF.FIXTURE_FX * max(FULL_HW) / max(FF.FIXTURE_HW)
    frames = rgb(three_faces(FACADE_SEED, FULL_HW, fx, FULL_OFFSETS, FULL_Z, n=2)[1])
    pose = WrapperStructPose(topology="BODY_25", net_hw=WIDE_HW)
    wide = Perception(pose=pose, face=face, hand=hand, device=device)
    wide_cpu = Perception(pose=dataclasses.replace(pose, params=copy.deepcopy(wide._pose_net).to(cpu)), face=face,
                          hand=hand, device=cpu)
    full = torch.from_numpy(frames).to(device)
    reset_launches()
    with face_landmark_maps() as maps:
        got = wide.emplace_and_pop(full[0])
        want = wide_cpu.emplace_and_pop(frames[0])
    compare_datum(f"full width facade {FULL_HW[1]}x{FULL_HW[0]} cuda vs cpu", got, want, maps=maps)
    print(f"full width facade: {int(got.people.mask.sum())} people (random weights), {int(got.faces['mask'].sum())} "
          f"faces, {int(got.hands['box_valid'].sum())} valid hand boxes")
    require(int(got.faces["mask"].sum()) == 3, "full width facade: not 3 faces")
    t_full = event_ms(lambda: wide.emplace_and_pop(full[1]))
    counts = read_launches()
    print(f"full width facade launches of K1-K4: {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the full-width facade")
    ops = posenet_ops(wide._pose_net, torch.zeros((1, 3) + WIDE_HW, device=device))
    print(f"full width facade (BODY_25 {WIDE_HW}, {MULTI_SLOTS} face slots, hands of 2 people, {FULL_HW[1]}x{FULL_HW[0]} "
          f"frames): {fmt_ms(t_full)} a frame (CUDA events, median of {TIMED_REPS} runs of {TIMED_CALLS}); pose CNN "
          f"bound {ops / PEAK_F32_OPS * 1e3:.4f} ms ({ops / 1e9:.3f} GFLOP)")
    print(f"full width facade stage ms (synchronized): {facade_stage_ms(wide, full[1])}")
    busy, wall, by_name, n_ops = device_profile(lambda: wide.emplace_and_pop(full[1]), 5)
    print(f"full width facade profile (torch.profiler, 5 frames): device busy share {busy:.4f}, wall {wall:.3f} ms a "
          f"frame, {n_ops / 5:.0f} device ops a frame, top device ms a frame {top_ms(by_name)}")
    print(f"facade phase: {time.perf_counter() - t_phase:.1f} s")


def textured(seed, hw=FULL_HW):
    """``tests/test_tracking.py``'s texture at ``hw``: random 8x8 blocks
    in [0, 200), blurred with a Gaussian of sigma 1.5."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    img = np.kron(rng.rand(hw[0] // 8, hw[1] // 8) * 200, np.ones((8, 8)))
    return gaussian_filter(img, 1.5).astype(np.float32)


def person_scene(frames=PERSON_FRAMES, people=PERSON_COUNT, pads=PERSON_PADS, shift=PERSON_SHIFT, seed=0):
    """PERSON_COUNT BODY_25-shaped people (a 25-part stick figure ~120 px
    tall, 2 rows of 4) on a 480x640 texture shifted ``shift`` px a frame
    to the right, the people with it; each frame's detections are the
    people in a random order with ~0.5 px jitter, then ``pads`` padding
    rows (mask False). (grays (F, H, W), detections (F, D, 25, 3), masks
    (F, D), true person index of each row (F, D), -1 padding)."""
    rng = np.random.default_rng(seed)
    base = textured(seed)
    figure = np.array([(0, 0), (0, 15), (-15, 15), (-22, 35), (-25, 55), (15, 15), (22, 35), (25, 55), (0, 60),
                       (-9, 60), (-11, 85), (-12, 110), (9, 60), (11, 85), (12, 110), (-4, -3), (4, -3), (-8, 0),
                       (8, 0), (14, 116), (18, 116), (12, 113), (-14, 116), (-18, 116), (-12, 113)], np.float32)
    anchors = np.array([(50 + 130 * (p % 4), 80 + 200 * (p // 4)) for p in range(people)], np.float32)
    grays, dets, masks, who = [], [], [], []
    for t in range(frames):
        grays.append(np.roll(base, shift * t, axis=1))
        order = rng.permutation(people)
        kp = anchors[order][:, None, :] + figure[None] + np.array([shift * t, 0.0], np.float32)
        kp = kp + rng.normal(0.0, 0.5, kp.shape).astype(np.float32)
        d = np.zeros((people + pads, 25, 3), np.float32)
        d[:people, :, :2], d[:people, :, 2] = kp, 1.0
        dets.append(d)
        masks.append(np.arange(people + pads) < people)
        who.append(np.concatenate([order, -np.ones(pads, np.int64)]))
    return np.stack(grays), np.stack(dets), np.stack(masks), np.stack(who)


def run_person_tracker(device):
    """The person tracker (``models/tracking.py``, pyramidal LK) at
    ``TrackerConfig()``'s defaults over PERSON_FRAMES frames of
    ``person_scene``: no id switch (each person keeps its first id),
    ``next_id`` = PERSON_COUNT, ids equal card vs CPU and keypoints within
    1e-3 px; no host sync; ms a step by CUDA events."""
    from perception_tpu_torch.models.tracking import TrackerConfig, tracker_init, tracker_step

    t_phase = time.perf_counter()
    cfg = TrackerConfig()
    grays, dets, masks, who = person_scene()
    on = {d: (torch.from_numpy(grays).to(d), torch.from_numpy(dets).to(d), torch.from_numpy(masks).to(d))
          for d in (device, "cpu")}
    states = {d: tracker_init(cfg, d) for d in on}
    first_id, switches, kp_diff = {}, 0, 0.0
    reset_launches()
    for t in range(PERSON_FRAMES):
        ids = {}
        for d, (g, x, m) in on.items():
            prev = g[max(t - 1, 0)]
            if d == device and t == 2:
                torch.cuda.synchronize()
                with recorded_syncs() as sites:
                    states[d], ids[d] = tracker_step(states[d], prev, g[t], x[t], m[t], cfg)
                torch.cuda.synchronize()
                require_syncs("tracker_step", sites, {})
            else:
                states[d], ids[d] = tracker_step(states[d], prev, g[t], x[t], m[t], cfg)
        card, host = ids[device].cpu(), ids["cpu"]
        require(torch.equal(card, host), f"person tracker frame {t}: ids differ between card and CPU")
        kp_diff = max(kp_diff, float((states[device].keypoints.cpu() - states["cpu"].keypoints).abs().max()))
        for row, person in enumerate(who[t]):
            if person >= 0:
                pid = int(card[row])
                switches += int(first_id.setdefault(int(person), pid) != pid or pid < 0)
    counts = read_launches()
    next_id = int(states[device].next_id)
    print(f"person tracker path launches of K1-K4: {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the person tracker path")
    print(f"person tracker (TrackerConfig() defaults, {PERSON_COUNT} BODY_25 people + {PERSON_PADS} padding rows, "
          f"{PERSON_FRAMES} frames {FULL_HW[1]}x{FULL_HW[0]}, {PERSON_SHIFT} px a frame): id switches {switches} "
          f"(want 0), next_id {next_id} (want {PERSON_COUNT}), ids card == cpu every frame, keypoints max diff "
          f"{kp_diff:.3e} px (limit 1e-3)")
    require(switches == 0 and next_id == PERSON_COUNT and kp_diff <= 1e-3, "person tracker: a gate missed")

    g, x, m = on[device]
    st = [states[device]]

    def step():
        st[0], _ = tracker_step(st[0], g[0], g[1], x[1], m[1], cfg)

    t_step = event_ms(step)
    busy, wall, by_name, n_ops = device_profile(step, 10)
    print(f"tracker_step: {fmt_ms(t_step)} (CUDA events, median of {TIMED_REPS} runs of {TIMED_CALLS}); profile "
          f"(torch.profiler, 10 steps): device busy share {busy:.4f}, wall {wall:.3f} ms a step, {n_ops / 10:.0f} device "
          f"ops a step, top device ms a step {top_ms(by_name)}")
    print(f"person tracker phase: {time.perf_counter() - t_phase:.1f} s")


def leaf_rgb(camera, i, seed=LEAF_SEED):
    """Bench frame ``i``'s colour image, aligned with the depth camera: a
    seeded two-scale texture that is never red (green above red and blue
    everywhere, hue 60-180 degrees), and the box's pixels of the noiseless
    render painted RGB (200, 20, 20) with +-10 noise a channel. Returns
    (rgb (H, W, 3) uint8, box pixels (H, W) bool)."""
    from perception_tpu_torch.bench.scene import bench_twist, render_depth_tabletop

    H, W = camera.height, camera.width
    rng = np.random.default_rng(seed + i)
    coarse = rng.integers(0, 60, (H // 16 + 1, W // 16 + 1, 3))
    tex = np.kron(coarse, np.ones((16, 16, 1), np.int64))[:H, :W] + rng.integers(0, 20, (H, W, 3))
    rgb = np.stack([20 + tex[..., 0], 110 + tex[..., 1], 30 + tex[..., 2]], axis=-1)
    box = render_depth_tabletop(camera, bench_twist(i), noise=0.0) < 0.85 - 1e-6
    rgb[box] = np.array([200, 20, 20]) + rng.integers(-10, 11, (int(box.sum()), 3))
    return rgb.astype(np.uint8), box


def opened_rect(mask):
    """The reference detector's rectangle for a mask of exactly the red
    pixels, by scipy: a 5x5 erosion twice (the border counts as
    foreground) and dilation twice, the largest 4-connected component
    (the first in raster order among equals), its bounding box +-10 px."""
    from scipy import ndimage

    k = np.ones((5, 5), bool)
    m = ndimage.binary_erosion(mask, k, iterations=2, border_value=1)
    m = ndimage.binary_dilation(m, k, iterations=2)
    labels, n = ndimage.label(m)
    require(n > 0, "opened_rect: no component")
    big = 1 + int(np.argmax(np.bincount(labels.ravel())[1:]))
    ys, xs = np.nonzero(labels == big)
    return xs.min() - 10, ys.min() - 10, xs.max() + 10, ys.max() + 10


def box_corners(pose, dims=(0.2, 0.1, 0.03)):
    """The 8 corners (8, 3) of a dims box under ``pose`` (object -> camera)."""
    half = np.asarray(dims) / 2.0
    signs = np.array(list(itertools.product((-1, 1), repeat=3)), np.float64)
    return (signs * half @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)


def tabletop_cloud(seed=0, twist=(0.08, 0.04, 0.83, 0.0, 0.0, 0.4), dims=(0.2, 0.1, 0.03), n_table=15000,
                   noise=0.0015):
    """tests/test_models.py's tabletop scene: a table plane and one cuboid
    template seen at an angle, so that three of its faces show. Returns
    (points (N, 3) float32, the cuboid's centre)."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.io.templates import cuboid_template

    rng = np.random.RandomState(seed)
    table = np.stack([rng.uniform(-0.35, 0.35, n_table), rng.uniform(-0.3, 0.3, n_table),
                      np.full(n_table, 0.85)], 1)
    T = se3.se3_exp(torch.tensor(twist, dtype=torch.float32)).numpy()
    obj = cuboid_template(*dims, density=0.004) @ T[:3, :3].T + T[:3, 3]
    cloud = np.concatenate([table, obj]).astype(np.float32)
    cloud += rng.randn(*cloud.shape) * noise
    return cloud.astype(np.float32), T[:3, 3]


def surface_indices(points, mask, normal, gen, num=512, threshold=0.008, eps_angle=0.1):
    """The triplets that ``estimate_surface_frame`` draws from ``gen`` for
    its three fits, each on the mask left by the fits before it (on the CPU)."""
    from perception_tpu_torch.ops.ransac import _sample_indices, ransac_plane

    idx, m = [], mask
    for model in ("perpendicular", "parallel", "parallel"):
        idx.append(_sample_indices(gen, m, num))
        fit = ransac_plane(points, m, None, threshold=threshold, num_hypotheses=num, model=model, axis=normal,
                           eps_angle=eps_angle, indices=idx[-1])
        m = m & ~fit.inliers
    return idx


def check_surface_frame(label, sf, center):
    """The frame's gates: orthonormal within 1e-5, right-handed (det > 0.99),
    origin within 5 cm of the box's centre. Returns the origin's error (m)."""
    pose = sf.pose.double().cpu().numpy()
    R = pose[:3, :3]
    orth = float(np.abs(R @ R.T - np.eye(3)).max())
    det = float(np.linalg.det(R))
    err = float(np.linalg.norm(pose[:3, 3] - center))
    require(orth <= 1e-5 and det > 0.99 and err < 0.05 and bool(torch.isfinite(sf.pose).all()),
            f"{label}: surface frame |R R^T - I| {orth:.2e}, det {det:.4f}, origin {err * 100:.2f} cm off the box")
    return orth, det, err


def run_leaf_nodes(device):
    """The reference's cuboid_detection leaf nodes on the 8 bench frames at
    640x480 (``bench/scene.py``) with a colour image made by ``leaf_rgb``:
    ``detect_red_object`` (HSV threshold, 5x5 erode and dilate twice, the
    largest component's rectangle +-10 px), ``project_bbox`` of the box's 8
    corners, ``filter_by_rect`` on the decimated cloud, then
    ``segment_ground_plane`` and ``estimate_surface_frame`` (three fits,
    each one K1 launch at B=1 N=8192 K=512), and the surface frame on
    tests/test_models.py's tabletop scene, where three faces show.

    Gates: the rectangle equal to ``opened_rect`` of the box's pixels (the
    same morphology by scipy), every corner inside it, every decimated box
    point kept; the
    surface frame orthonormal within 1e-5, det > 0.99, origin within 5 cm
    of the box (valid on the tabletop, where three faces show); exactly 3
    K1 launches a surface frame; the card equal to the CPU on the same
    inputs and triplets (rectangles, kept points and inlier counts exact,
    pixels within 1e-4 px or 2 ulps, normals and pose within 1e-5); host
    syncs: none but the 3 eighs of a surface frame. Returns the K1
    launches at K=1024 (ground planes) and at K=512 (surface frames)."""
    from perception_tpu_torch.bench.scene import bench_frames
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.bbox_filter import filter_by_rect, project_bbox, project_P
    from perception_tpu_torch.models.color_detect import detect_red_object
    from perception_tpu_torch.models.cuboid import CuboidConfig, decimate, segment_ground_plane
    from perception_tpu_torch.models.surface_frame import estimate_surface_frame
    from perception_tpu_torch.ops import ransac

    t_phase = time.perf_counter()
    cfg = CuboidConfig()
    camera = PinholeCamera.d435_depth()
    depths, gts = bench_frames(camera, range(FRAMES))
    rgbs, boxes = (np.stack(x) for x in zip(*(leaf_rgb(camera, i) for i in range(FRAMES))))
    P = np.concatenate([camera.K, np.zeros((3, 1), np.float32)], axis=1)
    corners = np.stack([box_corners(g) for g in gts])
    host = dict(rgb=torch.from_numpy(rgbs), depth=torch.from_numpy(depths), P=torch.from_numpy(P),
                E=torch.eye(4), corners=torch.from_numpy(corners))
    on = {"cpu": host, device: {k: v.to(device) for k, v in host.items()}}
    gen = torch.Generator(device=device).manual_seed(0)

    def front(d, i, g):
        x = on[d]
        rect = detect_red_object(x["rgb"][i])
        uv = project_bbox(x["P"], x["E"], x["corners"][i])
        dd, cam2 = decimate(x["depth"][i], camera, cfg.depth_stride)
        pts, m = cam2.backproject_depth(dd)
        kept = filter_by_rect(pts, m, x["P"], rect[:4])
        fit, dpts, box = segment_ground_plane(pts, m, g, cfg)
        return rect, uv, pts, m, kept, fit, dpts, box

    # The path, counted: the front nodes and ground planes, then the surface frames.
    table_np, table_center = tabletop_cloud()
    table_pts = torch.from_numpy(table_np).to(device)
    table_mask = torch.ones(len(table_np), dtype=torch.bool, device=device)
    reset_launches()
    fronts = [front(device, i, gen) for i in range(FRAMES)]
    tfit, tdpts, tbox = segment_ground_plane(table_pts, table_mask, gen, cfg)
    torch.cuda.synchronize()
    front_counts = read_launches()
    reset_launches()
    frames = [estimate_surface_frame(f[6], f[7], f[5].coefficients[:3], gen) for f in fronts]
    table_sf = estimate_surface_frame(tdpts, tbox, tfit.coefficients[:3], gen)
    torch.cuda.synchronize()
    sf_counts = read_launches()
    print(f"leaf nodes path: {FRAMES} x (detect_red_object, project_bbox, filter_by_rect, segment_ground_plane) "
          f"and the tabletop's ground plane: launches {front_counts}; {FRAMES} + 1 x estimate_surface_frame: "
          f"launches {sf_counts}")
    require(front_counts == {"ransac_score": FRAMES + 1, "icp_gn": 0, "voxelhash_query": 0},
            "leaf nodes: expected one K1 launch a ground plane and no other kernel")
    require(sf_counts == {"ransac_score": 3 * (FRAMES + 1), "icp_gn": 0, "voxelhash_query": 0},
            "leaf nodes: expected exactly 3 K1 launches a surface frame and no other kernel")

    for i, ((rect, uv, pts, m, kept, fit, dpts, box), sf) in enumerate(zip(fronts, frames)):
        r = [int(v) for v in torch.stack(list(rect)).cpu()]
        want = opened_rect(boxes[i])
        off = max(abs(a - b) for a, b in zip(r[:4], want))
        uvn = uv.cpu().numpy()
        inside = bool(np.all((uvn[:, 0] >= r[0]) & (uvn[:, 0] <= r[2]) & (uvn[:, 1] >= r[1]) & (uvn[:, 1] <= r[3])))
        box_dec = torch.from_numpy(boxes[i][1::2, 1::2].reshape(-1)).to(device)
        lost = int((box_dec & ~kept).sum())
        orth, det, err = check_surface_frame(f"leaf frame {i}", sf, gts[i][:3, 3])
        print(f"leaf frame {i}: rect {r[:4]} valid {bool(r[4])} (scipy's opening of the box pixels: "
              f"{list(map(int, want))}, off by "
              f"{off} px), corners inside {inside}, kept {int(kept.sum())} points of which box {int(box_dec.sum())}"
              f" (lost {lost}); ground plane valid {bool(fit.valid)}; surface frame valid {bool(sf.valid)} counts "
              f"{sf.inlier_counts.tolist()} |R R^T - I| {orth:.2e} det {det:.6f} origin {err * 100:.2f} cm")
        require(bool(r[4]) and off == 0 and inside and lost == 0, f"leaf frame {i}: the rectangle misses the box")
    orth, det, err = check_surface_frame("tabletop", table_sf, table_center)
    print(f"tabletop surface frame: valid {bool(table_sf.valid)} counts {table_sf.inlier_counts.tolist()} "
          f"|R R^T - I| {orth:.2e} det {det:.6f} origin {err * 100:.2f} cm")
    require(bool(table_sf.valid), "tabletop: the surface frame's three fits are not all valid")

    # The card against the port's CPU path, on the same inputs and triplets.
    worst = dict(uv=0.0, sf=0.0)
    cases = [(f[2], f[3], f[6], f[7], f[5].coefficients[:3], f[0]) for f in fronts]
    cases.append((None, None, tdpts, tbox, tfit.coefficients[:3], None))
    for i, (pts, m, dpts, box, normal, rect) in enumerate(cases):
        if rect is not None:
            c_rect = detect_red_object(host["rgb"][i])
            require(all(torch.equal(a.cpu(), b) for a, b in zip(rect, c_rect)),
                    f"leaf frame {i}: rectangles differ between card and CPU")
            c_uv = project_bbox(host["P"], host["E"], host["corners"][i])
            g_uv = project_bbox(on[device]["P"], on[device]["E"], on[device]["corners"][i]).cpu()
            require(torch.allclose(g_uv, c_uv, rtol=2.4e-7, atol=1e-4), f"leaf frame {i}: projected corners differ")
            worst["uv"] = max(worst["uv"], float((g_uv - c_uv).abs().max()))
            p_cpu = pts.cpu()
            c_kept = filter_by_rect(p_cpu, m.cpu(), host["P"], c_rect[:4])
            g_kept = filter_by_rect(pts, m, on[device]["P"], rect[:4]).cpu()
            q = project_P(host["P"], p_cpu)
            edge = torch.zeros(len(p_cpu), dtype=torch.bool)
            for k, v in enumerate(c_rect[:4]):
                edge |= (q[:, k % 2] - float(v)).abs() <= 1e-3
            require(torch.equal(c_kept[~edge], g_kept[~edge]), f"leaf frame {i}: kept points differ")
        d_cpu, b_cpu, n_cpu = dpts.cpu(), box.cpu(), normal.cpu()
        idx = surface_indices(d_cpu, b_cpu, n_cpu, torch.Generator().manual_seed(100 + i))
        c_sf = estimate_surface_frame(d_cpu, b_cpu, n_cpu, indices=idx)
        g_sf = estimate_surface_frame(dpts, box, normal, indices=[t.to(device) for t in idx])
        g_sf = type(g_sf)(*(t.cpu() for t in g_sf))
        diff = max(float((g_sf.pose - c_sf.pose).abs().max()), float((g_sf.face_normals - c_sf.face_normals).abs().max()))
        worst["sf"] = max(worst["sf"], diff)
        require(torch.equal(g_sf.inlier_counts, c_sf.inlier_counts) and bool(g_sf.valid) == bool(c_sf.valid)
                and diff <= 1e-5, f"leaf case {i}: surface frames differ between card and CPU ({diff:.2e})")
    print(f"leaf nodes cuda vs cpu (same inputs and triplets): rectangles, kept points and inlier counts equal; "
          f"corner pixels max diff {worst['uv']:.3e} px, surface frame max diff {worst['sf']:.3e}")

    # Host syncs: none but the refits' eigh (3 a surface frame).
    rect, uv, pts, m, kept, fit, dpts, box = fronts[0]
    x = on[device]
    eigh = f"ops/ransac.py:{source_line(ransac, 'torch.linalg.eigh(')}"
    torch.cuda.synchronize()
    with recorded_syncs() as sites:
        detect_red_object(x["rgb"][0])
        project_bbox(x["P"], x["E"], x["corners"][0])
        filter_by_rect(pts, m, x["P"], rect[:4])
    require_syncs("detect_red_object + project_bbox + filter_by_rect", sites, {})
    torch.cuda.synchronize()
    with recorded_syncs() as sites:
        estimate_surface_frame(dpts, box, fit.coefficients[:3], gen)
    require_syncs("estimate_surface_frame", sites, {eigh: 3})

    # ms a frame (host clock, synchronized), then each stage by CUDA events.
    runs = []
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = front(device, i, gen)
        estimate_surface_frame(f[6], f[7], f[5].coefficients[:3], gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    print(f"leaf nodes: {statistics.median(runs):.2f} ms a frame (median of {FRAMES}, frames "
          f"{[round(r, 2) for r in runs]})")
    stages = {
        "detect_red_object": lambda: detect_red_object(x["rgb"][0]),
        "project_bbox": lambda: project_bbox(x["P"], x["E"], x["corners"][0]),
        "filter_by_rect": lambda: filter_by_rect(pts, m, x["P"], rect[:4]),
        "segment_ground_plane": lambda: segment_ground_plane(pts, m, gen, cfg),
        "estimate_surface_frame": lambda: estimate_surface_frame(dpts, box, fit.coefficients[:3], gen),
    }
    print("leaf nodes stage ms (CUDA events, median of runs): " + ", ".join(
        f"{k} {fmt_ms(event_ms(fn))}" for k, fn in stages.items()))
    print(f"leaf nodes phase: {time.perf_counter() - t_phase:.1f} s")
    return front_counts["ransac_score"], sf_counts["ransac_score"]


def render_board(H, rows, cols, size=(480, 640), ss=3):
    """A chessboard with rows x cols inner corners through the homography H
    (board lattice -> image; inner corner (i, j) at lattice (i + 1, j + 1)),
    white outside the board, ``ss`` x ``ss`` supersampled; pixel i is centred
    at coordinate i (tests/test_chessboard.py's renderer). Returns (gray
    float32 in [0, 1], (rows*cols, 2) true inner corners row-major)."""
    h, w = size
    Hinv = np.linalg.inv(H)
    ys = (np.arange(h * ss) + 0.5) / ss - 0.5
    xs = (np.arange(w * ss) + 0.5) / ss - 0.5
    uu, vv = np.meshgrid(xs, ys)
    pix = np.stack([uu, vv, np.ones_like(uu)], -1) @ Hinv.T
    bx = pix[..., 0] / pix[..., 2]
    by = pix[..., 1] / pix[..., 2]
    inside = (bx >= 0) & (bx <= cols + 1) & (by >= 0) & (by <= rows + 1)
    checker = ((np.floor(bx).astype(int) + np.floor(by).astype(int)) % 2).astype(float)
    img = np.where(inside, checker, 1.0).reshape(h, ss, w, ss).mean((1, 3))
    gy, gx = np.meshgrid(np.arange(1, rows + 1), np.arange(1, cols + 1), indexing="ij")
    proj = np.stack([gx.ravel(), gy.ravel(), np.ones(rows * cols)], -1) @ H.T
    return img.astype(np.float32), (proj[:, :2] / proj[:, 2:3]).astype(np.float32)


def chain_scene(seed=CHAIN_SEED):
    """The 3-D chain's rig and boards: CHAIN_CAMERAS cameras 0.25 m apart on
    a line, each turned toward a point 2 m ahead, camera 0 the rig's frame;
    CHAIN_BOARDS poses of a CHAIN_ROWS x CHAIN_COLS inner-corner board of
    CHAIN_SQUARE squares 1.2-1.7 m ahead, tilted up to 0.35 rad about each
    axis, from numpy's default_rng(seed). Returns (Ks (C, 3, 3), true
    T_rig_cam (C, 4, 4), true T_rig_board (B, 4, 4), images (C, B, H, W),
    true corners (C, B, P, 2))."""
    from perception_tpu_torch.geometry import se3

    def rotation(w):
        return se3.so3_exp(torch.tensor(w, dtype=torch.float64)).numpy()

    rng = np.random.default_rng(seed)
    C, B = CHAIN_CAMERAS, CHAIN_BOARDS
    Ks = np.stack([np.array([[600.0 + 8 * c, 0, 320 - 4 * c], [0, 596.0 + 8 * c, 240 + 3 * c], [0, 0, 1]])
                   for c in range(C)])
    world_cam = []
    for c in range(C):
        x = -0.375 + 0.25 * c
        T = np.eye(4)
        T[:3, :3] = rotation([0.0, np.arctan2(-x, 2.0), 0.0])
        T[:3, 3] = [x, 0.02 * c, 0.0]
        world_cam.append(T)
    T_rig_cam = np.stack([np.linalg.inv(world_cam[0]) @ T for T in world_cam])
    rows, cols, sq = CHAIN_ROWS, CHAIN_COLS, CHAIN_SQUARE
    T_rig_board = []
    for _ in range(B):
        T = np.eye(4)
        T[:3, :3] = rotation(rng.uniform(-0.35, 0.35, 3))
        center = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.15, 0.15), rng.uniform(1.2, 1.7)])
        T[:3, 3] = center - T[:3, :3] @ np.array([(cols - 1) * sq / 2, (rows - 1) * sq / 2, 0.0])
        T_rig_board.append(np.linalg.inv(world_cam[0]) @ T)
    T_rig_board = np.stack(T_rig_board)
    lattice = np.array([[sq, 0, -sq], [0, sq, -sq], [0, 0, 1.0]])
    jobs = []
    for c in range(C):
        for b in range(B):
            T = np.linalg.inv(T_rig_cam[c]) @ T_rig_board[b]
            jobs.append(Ks[c] @ T[:3][:, [0, 1, 3]] @ lattice)
    with ThreadPoolExecutor(8) as pool:
        out = list(pool.map(lambda H: render_board(H, rows, cols), jobs))
    images = np.stack([o[0] for o in out]).reshape(C, B, 480, 640)
    corners = np.stack([o[1] for o in out]).reshape(C, B, rows * cols, 2)
    return Ks.astype(np.float32), T_rig_cam, T_rig_board, images, corners


def chain_people(rng, people=CHAIN_PEOPLE):
    """``people`` BODY_25 skeletons (people, 25, 3) in the rig's frame: the
    body model's 15 joints posed by forward kinematics (knees and elbows
    bent up to 0.5 rad, a yaw, a bone scale 0.95-1.05), 2.3-3.0 m ahead,
    and the 10 face and foot keypoints a few cm from their joints."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.models.body_fit import BODY15_TO_BODY25, BodyModel, forward_kinematics

    model = BodyModel.body15()
    out = np.zeros((people, 25, 3), np.float32)
    # BODY_25 index: (body-model joint it sits by, offset in m): eyes and ears
    # by the nose, toes and heels by the ankles.
    extra = {15: (2, [-0.03, -0.04, -0.05]), 16: (2, [0.03, -0.04, -0.05]), 17: (2, [-0.07, -0.02, 0.02]),
             18: (2, [0.07, -0.02, 0.02]), 19: (8, [0.02, 0.03, -0.12]), 20: (8, [0.06, 0.03, -0.1]),
             21: (8, [0.0, 0.04, 0.05]), 22: (5, [-0.02, 0.03, -0.12]), 23: (5, [-0.06, 0.03, -0.1]),
             24: (5, [0.0, 0.04, 0.05])}
    for p in range(people):
        angles = np.zeros((15, 3), np.float32)
        for j in (4, 7, 10, 13):
            angles[j] = rng.uniform(-0.5, 0.5, 3)
        twist = np.array([rng.uniform(-0.6, 0.6), 0.0, rng.uniform(2.3, 3.0), 0.0, rng.uniform(-0.6, 0.6), 0.0],
                         np.float32)
        T = se3.se3_exp(torch.from_numpy(twist))
        joints = forward_kinematics(model, T, torch.from_numpy(angles), float(rng.uniform(0.95, 1.05))).numpy()
        out[p, BODY15_TO_BODY25] = joints
        for k, (j, off) in extra.items():
            out[p, k] = joints[j] + np.asarray(off, np.float32)
    return out


def run_3d_chain(device):
    """OpenPose's 3-D module on the port: chessboard detection on
    CHAIN_CAMERAS x CHAIN_BOARDS rendered 640x480 views (``chain_scene``),
    Zhang calibration of each camera on its detected corners plus
    CHAIN_NOISE_PX of seeded noise, pairwise extrinsics to camera 0, the
    joint refinement of the rig at (C=4, B=12, P=54) from them, and again
    from its result perturbed as tests/test_calibration.py perturbs its
    initialisation (0.01 twists); then CHAIN_PEOPLE
    BODY_25 people projected through the refined cameras (1 px noise, 5%
    of the views masked), ``triangulate``, ``fit_body_from_body25`` over
    the people, ``save_bvh`` of CHAIN_BVH_FRAMES frames, and
    ``StereoCamera`` of cameras 0 and 1 over a disparity round trip.

    Gates (the JAX tests' at this size): corner error max < 0.7 px and mean
    < 0.4 px; fx within 15 px and cy within 10 px; refined rms below 0.5
    px, below the initial from the pairwise poses (which start within
    ~0.5 px) and below half the initial from the perturbed ones; triangulation error mean < 3 cm; fit
    residual < 2 cm a person; the BVH's header and frame count; the stereo
    round trip within 1e-5. The card against the CPU on the same inputs:
    corners within 1e-4 px, K within 1e-3 (the skew within 1e-3 of fx),
    board poses within 1e-3, the refined rms within 1e-4 px and poses
    within 1e-4, triangulated points within 1e-4 m with ``valid`` equal,
    fitted joints within 1 mm and residuals within 1e-4 m, stereo within
    1e-6 relative. Host syncs as each entry point states: the chessboard
    detector's one read, the eighs (one a call) and the SVD of
    ``se3.orthonormalize`` (two). No K1-K4 kernel runs here."""
    import tempfile
    from pathlib import Path

    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.geometry.stereo import StereoCamera
    from perception_tpu_torch.io.bvh import save_bvh
    from perception_tpu_torch.models.body_fit import fit_body_from_body25
    from perception_tpu_torch.models.pose import BODY_25_PAIRS, BODY_25_PARTS
    from perception_tpu_torch.ops import calibration, chessboard, triangulate as tri_mod
    from perception_tpu_torch.ops.calibration import (
        calibrate_camera,
        chessboard_object_points,
        joint_extrinsics_refine,
        pairwise_extrinsics,
    )
    from perception_tpu_torch.ops.chessboard import detect_chessboard_native
    from perception_tpu_torch.ops.triangulate import triangulate

    t_phase = time.perf_counter()
    Ks_true, T_cam_true, _, images, corners_true = chain_scene()
    C, B = CHAIN_CAMERAS, CHAIN_BOARDS
    rows, cols = CHAIN_ROWS, CHAIN_COLS
    print(f"3-D chain scene: {C} cameras x {B} boards of {rows}x{cols} inner corners at 640x480, rendered in "
          f"{time.perf_counter() - t_phase:.1f} s")
    stage = {}
    reset_launches()

    # 1. Chessboard corners on the card, every view; the CPU on the same images.
    t0 = time.perf_counter()
    imgs = torch.from_numpy(images).to(device)
    det = [[detect_chessboard_native(imgs[c, b], rows, cols) for b in range(B)] for c in range(C)]
    torch.cuda.synchronize()
    stage["detect_chessboard_native (48 views)"] = (time.perf_counter() - t0) * 1e3
    require(all(d is not None for row in det for d in row), "3-D chain: a board was not detected")
    det = np.stack([np.stack(row) for row in det])
    err = np.linalg.norm(det - corners_true, axis=-1)
    cpu_det = np.stack([np.stack([detect_chessboard_native(images[c, b], rows, cols, device="cpu")
                                  for b in range(B)]) for c in range(C)])
    det_diff = float(np.abs(det - cpu_det).max())
    print(f"chessboard: 48/48 boards found; corner error max {err.max():.4f} px mean {err.mean():.4f} px "
          f"(limits 0.7 / 0.4); card vs cpu max diff {det_diff:.3e} px")
    require(err.max() < 0.7 and err.mean() < 0.4, "chessboard: corner error over the JAX tests' gate")
    require(det_diff <= 1e-4, "chessboard: card and CPU corners differ")

    # 2. Zhang calibration of each camera on its corners + CHAIN_NOISE_PX noise.
    noisy = (det + np.random.default_rng(CHAIN_SEED + 1).normal(0, CHAIN_NOISE_PX, det.shape)).astype(np.float32)
    obj = chessboard_object_points(rows, cols, CHAIN_SQUARE)
    obj_d, obs_d = torch.from_numpy(obj).to(device), torch.from_numpy(noisy).to(device)
    t0 = time.perf_counter()
    calib = [calibrate_camera(obj_d, obs_d[c]) for c in range(C)]
    torch.cuda.synchronize()
    stage["calibrate_camera (4 cameras)"] = (time.perf_counter() - t0) * 1e3
    Ks = torch.stack([k for k, _ in calib])
    T_cam_board = torch.stack([t for _, t in calib])
    cpu_calib = [calibrate_camera(torch.from_numpy(obj), torch.from_numpy(noisy[c])) for c in range(C)]
    k_card, k_cpu = Ks.cpu().numpy(), np.stack([k.numpy() for k, _ in cpu_calib])
    diag = (slice(None), [0, 1, 0, 1], [0, 1, 2, 2])
    k_rel = float(np.abs(k_card[diag] / k_cpu[diag] - 1).max())
    skew = float(np.abs(k_card[:, 0, 1] - k_cpu[:, 0, 1]).max() / k_cpu[:, 0, 0].min())
    t_diff = float(np.abs(T_cam_board.cpu().numpy() - np.stack([t.numpy() for _, t in cpu_calib])).max())
    for c in range(C):
        print(f"camera {c}: fx {k_card[c, 0, 0]:.3f} fy {k_card[c, 1, 1]:.3f} cx {k_card[c, 0, 2]:.3f} "
              f"cy {k_card[c, 1, 2]:.3f} skew {k_card[c, 0, 1]:.4f} (true fx {Ks_true[c, 0, 0]:.1f} "
              f"cy {Ks_true[c, 1, 2]:.1f})")
    print(f"calibration card vs cpu: K rel diff {k_rel:.3e} (skew {skew:.3e} of fx), board poses max diff {t_diff:.3e}")
    require(np.all(np.abs(k_card[:, 0, 0] - Ks_true[:, 0, 0]) < 15) and np.all(np.abs(k_card[:, 1, 2] - Ks_true[:, 1, 2]) < 10),
            "calibration: fx or cy off the JAX tests' gate")
    require(k_rel <= 1e-3 and skew <= 1e-3 and t_diff <= 1e-3, "calibration: card and CPU differ")

    # 3. Pairwise extrinsics to camera 0, then the joint refinement.
    t0 = time.perf_counter()
    T_rig_cam0 = torch.stack([torch.eye(4, device=device)] +
                             [pairwise_extrinsics(T_cam_board[0], T_cam_board[c]) for c in range(1, C)])
    torch.cuda.synchronize()
    stage["pairwise_extrinsics (3 pairs)"] = (time.perf_counter() - t0) * 1e3
    obj3 = torch.cat([obj_d, torch.zeros_like(obj_d[:, :1])], dim=1)
    mask = torch.ones((C, B), dtype=torch.bool, device=device)
    args = (T_rig_cam0, T_cam_board[0], Ks, obj3, obs_d, mask)
    t0 = time.perf_counter()
    Tc, Tb, rms0, rms1 = joint_extrinsics_refine(*args)
    torch.cuda.synchronize()
    stage["joint_extrinsics_refine (C=4, B=12, P=54)"] = (time.perf_counter() - t0) * 1e3
    cTc, cTb, crms0, crms1 = joint_extrinsics_refine(*(a.cpu() for a in args))
    pose_diff = max(float((Tc.cpu() - cTc).abs().max()), float((Tb.cpu() - cTb).abs().max()))
    rms_diff = max(abs(float(rms0) - float(crms0)), abs(float(rms1) - float(crms1)))
    t_err = np.linalg.norm(Tc.cpu().numpy()[:, :3, 3] - T_cam_true[:, :3, 3], axis=-1)
    print(f"joint refinement from the pairwise initialisation: rms {float(rms0):.4f} -> {float(rms1):.4f} px "
          f"(limits: below the initial, below 0.5); camera positions off the truth "
          f"{np.round(t_err * 1e3, 2).tolist()} mm; card vs cpu rms diff {rms_diff:.3e} px, poses {pose_diff:.3e}")
    require(float(rms1) < float(rms0) and float(rms1) < 0.5, "joint refinement: rms over the gate")
    require(rms_diff <= 1e-4 and pose_diff <= 1e-4, "joint refinement: card and CPU differ")
    # tests/test_calibration.py's setting on this rig: the refined poses
    # perturbed by seeded 0.01 twists (camera 0 fixed), refined again.
    prng = np.random.default_rng(CHAIN_SEED + 4)
    pert_c = prng.normal(0, 0.01, (C, 6)).astype(np.float32)
    pert_c[0] = 0.0
    pert_b = prng.normal(0, 0.01, (B, 6)).astype(np.float32)
    p_args = (se3.se3_exp(torch.from_numpy(pert_c).to(device)) @ Tc,
              se3.se3_exp(torch.from_numpy(pert_b).to(device)) @ Tb, *args[2:])
    pTc, pTb, prms0, prms1 = joint_extrinsics_refine(*p_args)
    cp = joint_extrinsics_refine(*(a.cpu() for a in p_args))
    p_diff = max(abs(float(prms1) - float(cp[3])), float((pTc.cpu() - cp[0]).abs().max()))
    print(f"joint refinement from the perturbed initialisation: rms {float(prms0):.4f} -> {float(prms1):.4f} px "
          f"(limits: below half the initial, below 0.5); card vs cpu {p_diff:.3e}")
    require(float(prms1) < 0.5 * float(prms0) and float(prms1) < 0.5,
            "joint refinement: rms over the JAX test's gate")
    require(p_diff <= 1e-4, "joint refinement (perturbed): card and CPU differ")

    # 4. BODY_25 people through the refined cameras: triangulate, fit, BVH.
    rng = np.random.default_rng(CHAIN_SEED + 2)
    people = chain_people(rng)
    Pm = (Ks @ se3.inverse(Tc)[:, :3, :]).cpu().numpy()
    X = people.reshape(-1, 3).astype(np.float64)
    proj = np.einsum("cij,nj->nci", Pm.astype(np.float64), np.concatenate([X, np.ones((len(X), 1))], 1))
    uv = (proj[..., :2] / proj[..., 2:] + rng.normal(0, 1.0, proj[..., :2].shape)).astype(np.float32)
    vis = rng.random(uv.shape[:2]) >= 0.05
    tri_in = {d: tuple(torch.from_numpy(a).to(d) for a in (Pm, uv, vis)) for d in (device, "cpu")}
    t0 = time.perf_counter()
    res = triangulate(*tri_in[device])
    torch.cuda.synchronize()
    stage["triangulate (200 points)"] = (time.perf_counter() - t0) * 1e3
    cres = triangulate(*tri_in["cpu"])
    valid = res.valid.cpu().numpy()
    tri_err = np.linalg.norm(res.points.cpu().numpy() - people.reshape(-1, 3), axis=-1)[valid]
    p_diff = float((res.points.cpu() - cres.points).abs()[cres.valid].max())
    print(f"triangulation: {int(valid.sum())}/{len(valid)} valid, {int((~vis).sum())} of {vis.size} views masked; "
          f"error mean {tri_err.mean() * 100:.3f} cm max {tri_err.max() * 100:.3f} cm (limit: mean < 3 cm); card vs "
          f"cpu points max diff {p_diff:.3e} m, valid equal {torch.equal(res.valid.cpu(), cres.valid)}")
    require(tri_err.mean() < 0.03, "triangulation: error over the JAX test's gate")
    require(torch.equal(res.valid.cpu(), cres.valid) and p_diff <= 1e-4, "triangulation: card and CPU differ")

    kp = res.points.reshape(CHAIN_PEOPLE, 25, 3)
    conf = res.valid.reshape(CHAIN_PEOPLE, 25).to(torch.float32) * 0.9
    t0 = time.perf_counter()
    fit = fit_body_from_body25(kp, conf)
    torch.cuda.synchronize()
    stage[f"fit_body_from_body25 ({CHAIN_PEOPLE} people)"] = (time.perf_counter() - t0) * 1e3
    cfit = fit_body_from_body25(kp.cpu(), conf.cpu())
    resid = fit.residual.cpu().numpy()
    j_diff = float((fit.joints.cpu() - cfit.joints).abs().max())
    r_diff = float((fit.residual.cpu() - cfit.residual).abs().max())
    same_steps = torch.equal(fit.accepted.cpu(), cfit.accepted)
    print(f"body fit: residual a person {np.round(resid * 100, 3).tolist()} cm (limit 2 cm); LM steps accepted "
          f"{fit.accepted.sum(-1).tolist()} of {fit.accepted.shape[-1]}; card vs cpu joints max diff {j_diff:.3e} m, "
          f"residual {r_diff:.3e} m, accept patterns equal {same_steps}")
    require(np.all(resid < 0.02), "body fit: a residual over 2 cm")
    require(j_diff <= 1e-3 and r_diff <= 1e-4, "body fit: card and CPU differ")

    frames = [kp[0].cpu().numpy() + np.float32(0.01 * k) * np.array([1, 0, 0], np.float32)
              for k in range(CHAIN_BVH_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_bvh(Path(tmp) / "chain.bvh", frames, BODY_25_PAIRS, BODY_25_PARTS)
        stage[f"save_bvh ({CHAIN_BVH_FRAMES} frames)"] = (time.perf_counter() - t0) * 1e3
        text = (Path(tmp) / "chain.bvh").read_text()
    motion = text.split("Frame Time:")[1].strip().splitlines()[1:]
    print(f"bvh: {len(text)} bytes, {text.count('JOINT')} joints, {len(motion)} motion lines")
    require(text.startswith("HIERARCHY") and "ROOT MidHip" in text and f"Frames: {CHAIN_BVH_FRAMES}" in text
            and len(motion) == CHAIN_BVH_FRAMES, "bvh: the file is not as written")

    # 5. A stereo pair of cameras 0 and 1: a disparity round trip.
    K0 = Ks[0].cpu().numpy()
    st = StereoCamera(left=PinholeCamera.from_K(K0), baseline=float(Tc[1, :3, 3].norm()))
    depth_np = np.random.default_rng(CHAIN_SEED + 3).uniform(0.5, 5.0, (480, 640)).astype(np.float32)
    outs = {}
    for d in (device, "cpu"):
        depth = torch.from_numpy(depth_np).to(d)
        disp = st.depth_to_disparity(depth)
        outs[d] = (st.disparity_to_depth(disp), *st.disparity_image_to_3d(disp))
    back, pts, ok = (t.cpu() for t in outs[device])
    rt = float((back.numpy() / depth_np - 1).__abs__().max())
    vv, uu = np.meshgrid(np.arange(480), np.arange(640), indexing="ij")
    # The rectified pair's Q has one focal length: Y = (v - cy) Z / fx.
    xyz = np.stack([(uu - st.left.cx) * depth_np / st.left.fx, (vv - st.left.cy) * depth_np / st.left.fx, depth_np], -1)
    geo = float((np.abs(pts.numpy() - xyz) / depth_np[..., None]).max())
    st_diff = max(float(((a.cpu() - b).abs() / b.abs().clamp(min=1e-6)).max()) for a, b in zip(outs[device], outs["cpu"])
                  if a.is_floating_point())
    print(f"stereo (cameras 0-1, baseline {st.baseline:.4f} m): depth round trip rel err {rt:.3e} (limit 1e-5), 3-D "
          f"points against the pinhole rel err {geo:.3e}, all valid {bool(ok.all())}; card vs cpu rel diff {st_diff:.3e}")
    require(rt <= 1e-5 and geo <= 1e-4 and bool(ok.all()) and st_diff <= 1e-6, "stereo: a gate missed")
    counts = read_launches()
    print(f"3-D chain path launches of K1-K4: {counts}")
    require(not any(counts.values()), "a K1-K4 kernel ran on the 3-D chain")

    # Host syncs as each entry point states.
    cal_src, cb_src, tri_src = calibration, chessboard, tri_mod
    sync_cases = [
        ("detect_chessboard_native", lambda: detect_chessboard_native(imgs[0, 0], rows, cols),
         {f"ops/chessboard.py:{source_line(cb_src, '.cpu().numpy()')}": 1}),
        ("calibrate_camera", lambda: calibrate_camera(obj_d, obs_d[0]),
         {f"ops/calibration.py:{source_line(cal_src, 'torch.linalg.eigh(A.transpose')}": 1,
          f"ops/calibration.py:{source_line(cal_src, 'torch.linalg.eigh(Vm.T')}": 1,
          f"geometry/se3.py:{source_line(se3, 'torch.linalg.svd(')}": 2}),
        ("pairwise_extrinsics", lambda: pairwise_extrinsics(T_cam_board[0], T_cam_board[1]),
         {f"ops/calibration.py:{source_line(cal_src, 'torch.linalg.eigh(qs.T')}": 1}),
        ("joint_extrinsics_refine", lambda: joint_extrinsics_refine(*args, iterations=2), {}),
        ("triangulate", lambda: triangulate(*tri_in[device]),
         {f"ops/triangulate.py:{source_line(tri_src, 'torch.linalg.eigh(')}": 1}),
        ("fit_body_from_body25", lambda: fit_body_from_body25(kp, conf, iterations=2), {}),
        ("StereoCamera", lambda: st.disparity_image_to_3d(st.depth_to_disparity(imgs[0, 0] + 1.0)), {}),
    ]
    for label, fn, want in sync_cases:
        torch.cuda.synchronize()
        with recorded_syncs() as sites:
            fn()
        require_syncs(label, sites, want)
    print("3-D chain stage ms, first calls (host clock, synchronized): " +
          ", ".join(f"{k} {v:.2f}" for k, v in stage.items()))
    warm = {
        "detect_chessboard_native (a view)": lambda: detect_chessboard_native(imgs[0, 0], rows, cols),
        "calibrate_camera (a camera)": lambda: calibrate_camera(obj_d, obs_d[0]),
        "pairwise_extrinsics (a pair)": lambda: pairwise_extrinsics(T_cam_board[0], T_cam_board[1]),
        "joint_extrinsics_refine (10 steps)": lambda: joint_extrinsics_refine(*args),
        "triangulate (200 points)": lambda: triangulate(*tri_in[device]),
        f"fit_body_from_body25 ({CHAIN_PEOPLE} people, 30 steps)": lambda: fit_body_from_body25(kp, conf),
    }
    print("3-D chain ms a call, warm (host clock, synchronized; median, min-max of 3): " +
          ", ".join(f"{k} {fmt_ms(sync_ms(fn))}" for k, fn in warm.items()))
    print(f"3-D chain phase: {time.perf_counter() - t_phase:.1f} s")


def step_against_cpu(label, net, batch, loss_fn, lr=TRAIN_LR):
    """One ``make_train_step`` SGD step of ``net`` (on the card) and of its
    copy on the CPU from the same weights and batch: the loss, every
    gradient and the parameters after the step, held to TRAIN_LOSS_RTOL,
    TRAIN_GRAD_TOL and TRAIN_PARAM_TOL. Returns the card's trained net."""
    import copy

    from perception_tpu_torch.models import train

    cpu_net = copy.deepcopy(net).cpu()
    cpu_batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    opt = train.make_optimizer(lr, "sgd")
    step = train.make_train_step(opt, loss_fn)
    (card, card_loss), (cpu, cpu_loss) = (step(train.init_train_state(n, opt), b)
                                          for n, b in ((net, batch), (cpu_net, cpu_batch)))
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_err = param_err = 0.0
    worst = ""
    for (name, p), q in zip(card.params.named_parameters(), cpu.params.parameters()):
        require((p.grad is None) == (q.grad is None), f"{label}: a parameter has a gradient on one device only")
        if q.grad is None:  # outside the loss (the AU head's presence logits)
            continue
        g, h = p.grad.cpu(), q.grad
        err = float((g - h).abs().max()) / max(float(h.abs().max()), 1e-30)
        if err > grad_err:
            grad_err, worst = err, name
        param_err = max(param_err, float((p.detach().cpu() - q.detach()).abs().max()))
    print(f"{label}: one SGD step card against CPU: loss {float(card_loss):.6f} / {float(cpu_loss):.6f} "
          f"(rel {loss_rel:.2e}), gradients max diff {grad_err:.2e} of each tensor's largest ({worst}), parameters "
          f"after the step max diff {param_err:.2e}")
    require(np.isfinite(float(card_loss)) and loss_rel <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and param_err <= TRAIN_PARAM_TOL, f"{label}: the card's step differs from the CPU's beyond the tolerances")
    return card.params


def check_fixture_file(label, module, net, path, device):
    """``save_fixture`` of ``net``, read back by the port's reader: equal to
    the float16 rounding of the weights."""
    module.save_fixture(net, path)
    back = module.load_fixture(device, path)
    nets = {"landmark": (net["landmark"], back["landmark"]), "au": (net["au"], back["au"]),
            "det": (net["det"], back["det"])} if isinstance(back, dict) else {"": (net, back)}
    same = all(torch.equal(a.detach().half().float(), b) for orig, loaded in nets.values()
               for a, b in zip(orig.state_dict().values(), loaded.state_dict().values()))
    print(f"{label}: save_fixture -> load_fixture equal to the float16 weights: {same} "
          f"({path.stat().st_size} bytes)")
    require(same, f"{label}: the written fixture does not read back as the float16 weights")


def run_training(device):
    """The training path at full width and the checkpoints (module docstring)."""
    import copy
    import tempfile
    from pathlib import Path

    from perception_tpu_torch.models import face_fixture, hand_fixture, pose_fixture, train
    from perception_tpu_torch.models.face_data import make_face_batch
    from perception_tpu_torch.models.pose import init_posenet
    from perception_tpu_torch.models.pose_data import make_batch
    from perception_tpu_torch.utils import checkpoint, roofline

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools_torch"))
    import train_face_fixture
    import train_hand_fixture

    t_phase = time.perf_counter()
    reset_launches()
    tmp = Path(tempfile.mkdtemp(prefix="train_"))

    # Full width: example 06's MPI_15 PoseNet at 368x368, B=8.
    net0 = init_posenet(torch.Generator().manual_seed(TRAIN_SEED), TRAIN_TOPOLOGY, device)
    t0 = time.perf_counter()
    batch = make_batch(np.random.default_rng(TRAIN_SEED), TRAIN_BATCH, TRAIN_HW, n_people=TRAIN_PEOPLE, device=device)
    torch.cuda.synchronize()
    people = int(batch["scene"].valid.sum())
    print(f"training batch: {TRAIN_BATCH} scenes at {TRAIN_HW[0]}x{TRAIN_HW[1]}, {people} people, made on the card in "
          f"{time.perf_counter() - t0:.2f} s; image {tuple(batch['image'].shape)}, paf {tuple(batch['paf'].shape)}, "
          f"heatmap {tuple(batch['heatmap'].shape)}")
    step_against_cpu(f"PoseNet {TRAIN_TOPOLOGY} {TRAIN_HW[0]}x{TRAIN_HW[1]} B={TRAIN_BATCH}", copy.deepcopy(net0),
                     batch, train.pose_loss)

    opt = train.make_optimizer(TRAIN_LR, "adam")
    step = train.make_train_step(opt)
    state = train.init_train_state(copy.deepcopy(net0), opt)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    losses = [float(x) for x in losses]  # one read after the steps
    print(f"Adam at {TRAIN_LR}, {TRAIN_STEPS} steps on the fixed batch: losses {[round(x, 6) for x in losses]}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "training: the loss is not finite or did not fall")
    with recorded_syncs() as sites:
        state, _ = step(state, batch)
    require_syncs("training step", sites, {})
    flops, _ = roofline.cost_of(lambda: step(state, batch))  # one more step, its operations counted
    ms = []
    for _ in range(TRAIN_TIMED):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    peak = torch.cuda.max_memory_allocated()
    f32 = roofline.device_peaks(device)
    step_ms = statistics.median(ms)
    share = flops / (step_ms * 1e-3) / (f32[0] * 1e12) if f32 else None
    print(f"training step (Adam, B={TRAIN_BATCH}, {TRAIN_HW[0]}x{TRAIN_HW[1]}): {step_ms:.4f} ms median of "
          f"{TRAIN_TIMED} by CUDA events (runs {min(ms):.4f}-{max(ms):.4f}); {flops / 1e9:.3f} GFLOP a step "
          f"(FlopCounterMode: convolutions forward and backward), {flops / (step_ms * 1e-3) / 1e12:.3f} TFLOP/s, "
          f"share of the f32 peak {share if share is None else round(share, 4)} "
          f"({f32[0] if f32 else 'unknown'} TFLOP/s); max_memory_allocated {peak / 2**30:.3f} GiB")

    # TrainState snapshot and restore on the card, bit-equal.
    train.snapshot(tmp / "state.pt", state)
    other = train.init_train_state(init_posenet(torch.Generator().manual_seed(TRAIN_SEED + 1), TRAIN_TOPOLOGY, device),
                                   opt)
    back = train.restore(tmp / "state.pt", other)
    same = back.step == state.step and all(
        torch.equal(a, b) for a, b in zip(state.params.state_dict().values(), back.params.state_dict().values()))
    sa, sb = state.opt_state.state_dict()["state"], back.opt_state.state_dict()["state"]
    same = same and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    print(f"TrainState snapshot -> restore on the card at step {state.step}: bit-equal {same}")
    require(same, "training: the restored TrainState differs from the saved one")
    del state, back, other, batch

    # Training from scratch: the hand fixture trainer.
    t0 = time.perf_counter()
    args = train_hand_fixture.parse_args(["--steps", str(HAND_TRAIN_STEPS), "--eval-every", str(HAND_TRAIN_EVAL),
                                          "--out", str(tmp / "hand_best.msgpack")]
                                         + (["--cpu"] if device.type == "cpu" else []))
    result = train_hand_fixture.train(args, log=lambda line: print(f"  train_hand_fixture: {line}"))
    final = result["evals"][-1][2]
    print(f"hand fixture trained from init_tiny: untrained {result['untrained_px']:.2f} px, "
          f"{[(s, round(e, 2)) for s, _, e in result['evals']]} px, {result['s_per_step'] * 1e3:.3f} ms a step "
          f"(batch made on the card; host clock, synchronized), {time.perf_counter() - t0:.1f} s in all; "
          f"JAX package --cpu at {HAND_TRAIN_STEPS} steps: {HAND_JAX_PX} px")
    require(final < result["untrained_px"] and final <= 1.5 * HAND_JAX_PX and final <= HAND_TOOL_PX,
            f"hand trainer: {final:.2f} px is not below the untrained net's, 1.5x the JAX tool's and {HAND_TOOL_PX} px")
    check_fixture_file("hand fixture", hand_fixture, result["net"], tmp / "hand.msgpack", device)

    # The other two losses, from the committed fixtures, batches made on the card.
    gen = np.random.default_rng(TRAIN_SEED)
    pose_batch = make_batch(gen, FIXTURE_BATCH, pose_fixture.FIXTURE_HW, n_people=4, pixel_noise=0.10, device=device)
    pose_net = step_against_cpu("pose fixture loss (pose_loss)", pose_fixture.load_fixture(device), pose_batch,
                                train.pose_loss)
    check_fixture_file("pose fixture", pose_fixture, pose_net, tmp / "pose.msgpack", device)
    face_batch = make_face_batch(gen, FIXTURE_BATCH, rot_range=0.50, pixel_noise=0.12, device=device)
    face_net = step_against_cpu("face fixture loss (train_face_fixture.face_loss)",
                                torch.nn.ModuleDict(face_fixture.load_fixture(device)), face_batch,
                                train_face_fixture.face_loss)
    check_fixture_file("face fixture", face_fixture, face_net, tmp / "face.msgpack", device)
    launches = read_launches()
    print(f"training path kernel launches: {launches} (none runs K1-K4)")
    require(not any(launches.values()), "training: a K1-K4 kernel launched on the training path")

    # A SLAM session resumed mid-stream from a save_npz checkpoint.
    from perception_tpu_torch.bench.slam_bench import bench_config
    from perception_tpu_torch.models.slam import system

    camera, _, grays, depths = slam_scene(RESUME_FRAMES)
    grays, depths = torch.from_numpy(grays).to(device), torch.from_numpy(depths).to(device)
    cfg = bench_config()

    def run(state, gen, frames, out):
        for i in frames:
            state, diag = system.slam_step(state, depths[i], grays[i], camera, gen, cfg)
            out.append((state.odom.pose, diag.promoted))
        return state

    ref = []
    run(system.slam_init(camera, depths[0], grays[0], cfg), torch.Generator(device=device).manual_seed(0),
        range(1, RESUME_FRAMES), ref)
    got, gen = [], torch.Generator(device=device).manual_seed(0)
    state = run(system.slam_init(camera, depths[0], grays[0], cfg), gen, range(1, RESUME_CUT), got)
    checkpoint.save_npz(tmp / "slam", {"slam": state, "rng": gen.get_state()})
    size = (tmp / "slam.npz").stat().st_size
    del state, gen
    skeleton = {"slam": system.slam_init(camera, depths[0], grays[0], cfg), "rng": torch.Generator(device=device).get_state()}
    restored = checkpoint.load_npz(tmp / "slam", skeleton)
    gen = torch.Generator(device=device)
    gen.set_state(restored["rng"])
    run(restored["slam"], gen, range(RESUME_CUT, RESUME_FRAMES), got)
    diff = max(float((a - b).abs().max()) for (a, _), (b, _) in zip(got, ref))
    same_promotions = [bool(p) for _, p in got] == [bool(p) for _, p in ref]
    print(f"SLAM resumed mid-stream (640x480, checkpoint after frame {RESUME_CUT - 1} of {RESUME_FRAMES}, "
          f"{size / 2**20:.2f} MiB npz): promotions equal {same_promotions} "
          f"({sum(bool(p) for _, p in ref)}), poses max diff {diff:.3e} against the uninterrupted run")
    require(same_promotions and diff <= RESUME_TOL, "SLAM resume: the resumed trajectory differs")
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return flops


def run_multichip(train_flops):
    """The multi-device dry run (module docstring): each fleet's ranks are
    spawned processes (``dryrun.run``), so this process never joins a
    process group."""
    from perception_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    runs = {}
    for backend, dev, ranks in MULTICHIP_RUNS:
        t0 = time.perf_counter()
        # The CPU fleet is compared, not timed, and not held to its own single rank: the card's fleets are.
        runs[(backend, dev, ranks)] = dryrun.run(ranks, backend, dev, reps=0 if dev == "cpu" else 3,
                                                 threads=max(1, MULTICHIP_HOST_CORES // ranks), single=dev == "cuda")
        print(f"  (fleet of {ranks} on {dev} over {backend}: {time.perf_counter() - t0:.1f} s)")
    card, cpu = ({name: r[0] for name, r in runs[key].items()} for key in (("gloo", "cuda", 2), ("gloo", "cpu", 2)))
    diffs = {f"{step}/{key}": float(np.abs(card[step][key] - cpu[step][key]).max()) for step, key in
             (("icp", "transforms"), ("ba", "poses_wc"), ("ba", "landmarks"), ("map_odometry", "transforms"),
              ("pose_graph", "poses"), ("relaxer", "poses"))}
    ba_costs = [float(r["ba"][k]) for r in (card, cpu) for k in ("initial_cost", "final_cost")]
    loss_rel = abs(float(card["train"]["loss"]) - float(cpu["train"]["loss"])) / abs(float(cpu["train"]["loss"]))
    grads = card["train"]["grads"]
    grad_err, grad_at = max((float(np.abs(g - cpu["train"]["grads"][n]).max() /
                                   max(np.abs(cpu["train"]["grads"][n]).max(), 1e-30)), n) for n, g in grads.items())
    print("multichip card (R=2, gloo) against the CPU fleet (R=2, gloo): " +
          ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()) +
          f"; BA costs {ba_costs[0]:.4f} -> {ba_costs[1]:.3e} (card) / {ba_costs[2]:.4f} -> {ba_costs[3]:.3e} "
          f"(CPU); train loss {loss_rel:.3e} relative, gradients within {grad_err:.3e} of their largest ({grad_at})")
    require(max(diffs.values()) <= MULTICHIP_TRANSFORM_TOL, "multichip: the card's fleet differs from the CPU's")
    require(loss_rel <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL,
            "multichip: the card's data-parallel step differs from the CPU's")
    for (backend, dev, ranks), r in runs.items():
        if dev == "cuda":
            ms = r["train"][2]
            print(f"multichip R={ranks} {backend}: ms a call: " +
                  ", ".join(f"{name} {r[name][2]:.3f}" for name in MULTICHIP_STEPS) +
                  f"; the data-parallel step {train_flops / 1e9:.3f} GFLOP at {ms:.3f} ms, "
                  f"{train_flops / (ms / 1e3) / 1e12:.3f} TFLOP/s, share of the f32 peak "
                  f"{train_flops / PEAK_F32_OPS / (ms / 1e3):.4f}")
    print(f"multichip phase: {time.perf_counter() - t_phase:.1f} s")



EXAMPLE_K1 = {  # examples_torch stem -> its K1 launches in main() and their (B, N, K); the rest launch none
    "01_cuboid_pose_from_depth": (1, (1, 8192, 1024)),          # one cuboid RANSAC
    "02_multi_object_service": (1, (1, 32768, 1024)),           # detect_object's plane removal
    "09_cluttered_scene_with_gt_protocol": (4, (1, 32768, 256)),  # one detect_object a class, 256 hypotheses
    "12_multi_object_tracking": (10, (1, 16384, 1024)),         # one tracker front end a frame
}
EXAMPLES_CPU = ("05", "06", "08", "10", "11")  # held against the CPU: no draw inside an algorithm decides them
EX_ATE_TOL = 5e-3        # m: example 05's ATE, card against CPU (its loop closures' RANSAC draws differ)
EX_LOSS_RTOL = 1e-3      # example 06's five losses, card against CPU (cuDNN's convolutions sum in another order)
EX_GEOM_TOL = 1e-4       # px and m: example 08's round trips and stereo point, card against CPU
EX_FACE_TOL = 1e-3       # px (landmarks, boxes) and m / rotation entries (poses) and AU02: example 11
VIEWER_HW = (480, 640)   # Gui3D over the whole backprojected 640x480 bench frame
VIEWER_FRAMES = 3        # orbit frames, each held to the plain version
COCO_SCENES = 8          # run_pose's full-width batch: BODY_25 PoseNet() at 368x368, seeded weights
ROBUST_TOL = 0.05        # FIXTURES.md's numbers (PCK, recall, IoU, px, AU separation), card against the committed


def example_outputs(stem, device):
    """``main(device)`` of an example, and its ``main_facade(device)``
    where it has one, merged: the example's headline numbers."""
    from examples_torch._common import load

    mod = load(stem)
    out = dict(mod.main(device))
    if hasattr(mod, "main_facade"):
        out.update(mod.main_facade(device))
    return out


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def compare_example(stem, card, cpu):
    """The card's headline numbers against the CPU's for the examples of
    EXAMPLES_CPU, each within its stated tolerance."""
    if stem.startswith("05"):
        d = abs(card["ate_rmse"] - cpu["ate_rmse"])
        print(f"  05 card vs cpu: keyframes {card['keyframes']} / {cpu['keyframes']}, edges {card['edges']} / "
              f"{cpu['edges']}, ATE {card['ate_rmse']:.5f} / {cpu['ate_rmse']:.5f} m (diff {d:.2e}), "
              f"poses max diff {max_diff(card['poses'], cpu['poses']):.2e}")
        require(card["keyframes"] == cpu["keyframes"] and card["edges"] == cpu["edges"] and d <= EX_ATE_TOL,
                "example 05: the card's SLAM differs from the CPU's")
    elif stem.startswith("06"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
        print(f"  06 card vs cpu: losses {[round(x, 6) for x in card['losses']]} / "
              f"{[round(x, 6) for x in cpu['losses']]}, max relative diff {rel:.2e}")
        require(rel <= EX_LOSS_RTOL and card["bit_stable"], "example 06: the card's loss curve differs from the CPU's")
    elif stem.startswith("08"):
        geo = max(abs(card["ray_err"] - cpu["ray_err"]), abs(card["rect_err"] - cpu["rect_err"]),
                  max_diff(card["xyz"], cpu["xyz"]))
        same = (np.array_equal(card["depth_display"], cpu["depth_display"])
                and np.array_equal(card["label_display"], cpu["label_display"]))
        print(f"  08 card vs cpu: round trips and stereo point within {geo:.2e}; display images equal {same}")
        require(geo <= EX_GEOM_TOL and same, "example 08: the card differs from the CPU")
    elif stem.startswith("10"):
        # The clouds are backprojected on each device; each device's frames
        # are held to the plain renderer on its own cloud, and to each other.
        from perception_tpu_torch.io.gui import Gui3D
        from perception_tpu_torch.models.viz import render_points_3d_reference

        orbit = Gui3D(orbit_step_deg=30.0)  # the example's viewer: its eyes, frame by frame
        same = []
        for f in card["orbit_frames"]:
            same.append(np.array_equal(f, render_points_3d_reference(card["cloud"], size=(120, 160), eye=orbit.eye())))
            orbit.orbit += orbit.orbit_step
        px = sum(int((a != b).any(-1).sum()) for a, b in zip(card["orbit_frames"], cpu["orbit_frames"]))
        print(f"  10 viewer: the card's 4 orbit frames equal the plain version on its cloud {same}; "
              f"pixels differing from the CPU run's frames: {px}; cloud max diff "
              f"{max_diff(card['cloud'], cpu['cloud']):.2e} m; sink {card['sink']}, {card['bytes']} bytes")
        require(all(same) and px == 0, "example 10: the card's viewer frames differ")
    elif stem.startswith("11"):
        worst = 0.0
        for a, b in zip(card["faces"], cpu["faces"]):
            require(a["gate"] == b["gate"], "example 11: AU02 gates differ")
            worst = max(worst, max_diff(a["landmarks"], b["landmarks"]), max_diff(a["box"], b["box"]),
                        max_diff(a["pose"], b["pose"]), abs(a["au02"] - b["au02"]))
        print(f"  11 card vs cpu: gates equal, landmarks, boxes, poses and AU02 within {worst:.2e}")
        require(worst <= EX_FACE_TOL, "example 11: the card's face chain differs from the CPU's")


def run_examples(device):
    """Every ``examples_torch`` example on the card, then the viewer, codec
    and saver leaves at full width. Returns the examples' K1 launches by
    (B, N, K)."""
    from examples_torch._common import ROOT

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    host = {}
    for name in ("cv2", "matplotlib", "PySpin"):  # what the examples' optional paths find on this host
        try:
            host[name] = getattr(__import__(name), "__version__", "present")
        except ImportError:
            host[name] = "absent"
    print(f"examples' host: {host}")
    k1 = {}
    for path in sorted((ROOT / "examples_torch").glob("[0-9][0-9]_*.py")):
        stem = path.stem
        want, shape = EXAMPLE_K1.get(stem, (0, None))
        t0 = time.perf_counter()
        reset_launches()
        card = example_outputs(stem, device)
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"example {stem} on the card: {time.perf_counter() - t0:.1f} s, launches {launches}")
        require(launches == {"ransac_score": want, "icp_gn": 0, "voxelhash_query": 0},
                f"example {stem}: expected {want} K1 launches and no other kernel")
        if shape is not None:
            k1[shape] = k1.get(shape, 0) + want
        if stem[:2] in EXAMPLES_CPU:
            t0 = time.perf_counter()
            compare_example(stem, card, example_outputs(stem, cpu))
            print(f"  (the CPU run: {time.perf_counter() - t0:.1f} s)")
    print(f"examples: {time.perf_counter() - t_phase:.1f} s")
    run_leaves(device)
    print(f"examples phase: {time.perf_counter() - t_phase:.1f} s")
    return k1


def run_leaves(device):
    """The viewer, display, codec and saver leaves at full width."""
    import tempfile
    from pathlib import Path

    from perception_tpu_torch.bench.scene import render_depth_tabletop
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.io import imgcodec, savers
    from perception_tpu_torch.io.gui import FrameDisplayer, Gui3D
    from perception_tpu_torch.models import pose
    from perception_tpu_torch.models.viz import depth_to_vis, render_points_3d_reference

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cam = PinholeCamera.d435_depth()
    depth = render_depth_tabletop(cam, seed=0)

    # 1. Gui3D over the whole backprojected frame, each frame held to the plain version.
    pts, mask = cam.backproject_depth(torch.as_tensor(depth, device=device))
    cloud = pts[mask]
    host_cloud = cloud.cpu().numpy()
    g3 = Gui3D(hw=VIEWER_HW, orbit_step_deg=30.0, displayer=FrameDisplayer(sink=lambda f: None))
    plain_s = []
    for i in range(VIEWER_FRAMES):
        eye = g3.eye()
        img = g3.update(cloud).cpu().numpy()
        t0 = time.perf_counter()
        want = render_points_3d_reference(host_cloud, size=VIEWER_HW, eye=eye)
        plain_s.append(time.perf_counter() - t0)
        diff = int((img != want).any(-1).sum())
        print(f"Gui3D {VIEWER_HW} frame {i} over {len(host_cloud)} points: {diff} pixels differ from the plain "
              f"version, {int((want != 16).any(-1).sum())} pixels painted")
        require(diff == 0, "Gui3D: the card's frame differs from the plain version's")
    card_ms = event_ms(lambda: g3.update(cloud))
    plain_ms = statistics.median(plain_s) * 1e3
    print(f"Gui3D {VIEWER_HW}, {len(host_cloud)} points: card {fmt_ms(card_ms)} a frame (render + the frame to the "
          f"host, CUDA events); plain version (numpy loop) {plain_ms:.1f} ms a frame (host clock, median of "
          f"{VIEWER_FRAMES}); {plain_ms / card_ms[0]:.1f}x")

    # 2. Display conversions on 640x480 frames, card against CPU.
    labels = np.random.default_rng(5).integers(-1, 300, (480, 640)).astype(np.int32)
    d_nan = depth.copy()
    d_nan[::7, ::11] = np.nan
    checks = {
        "depth_to_vis": lambda d: depth_to_vis(torch.as_tensor(d_nan, device=d), max_depth=1.2),
        "cvt_color_for_display 32FC1 dynamic": lambda d: imgcodec.cvt_color_for_display(
            torch.as_tensor(d_nan, device=d), "32FC1", "bgr8", do_dynamic_scaling=True),
        "cvt_color_for_display 32SC1 labels": lambda d: imgcodec.cvt_color_for_display(
            torch.as_tensor(labels, device=d), "32SC1", "rgb8"),
    }
    for name, fn in checks.items():
        same = torch.equal(fn(device).cpu(), fn(cpu))
        print(f"{name} 480x640: card equals CPU {same}; card {fmt_ms(event_ms(lambda: fn(device)))} a frame")
        require(same, f"{name}: the card differs from the CPU")
    numpy_same = np.array_equal(depth_to_vis(d_nan, max_depth=1.2), depth_to_vis(torch.as_tensor(d_nan), 1.2).numpy())
    require(numpy_same, "depth_to_vis: numpy and tensor differ")

    # 3. imgcodec round trips at 640x480, little- and big-endian, and PNG.
    rng = np.random.default_rng(6)
    images = {"rgb8": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
              "16UC1": rng.integers(0, 65536, (480, 640), dtype=np.uint16),
              "32FC1": rng.random((480, 640), dtype=np.float32)}
    for enc, arr in images.items():
        msg = imgcodec.array_to_image(torch.as_tensor(arr, device=device), enc)
        big = dict(msg, is_bigendian=True, data=arr.astype(arr.dtype.newbyteorder(">")).tobytes())
        ok = np.array_equal(imgcodec.image_to_array(msg), arr) and np.array_equal(imgcodec.image_to_array(big), arr)
        if enc != "32FC1":
            ok = ok and np.array_equal(imgcodec.compressed_to_array(imgcodec.array_to_compressed(arr, "png")), arr)
        print(f"imgcodec {enc} 480x640: raw little/big-endian{'' if enc == '32FC1' else ' and PNG'} round trips equal {ok}")
        require(ok, f"imgcodec {enc}: round trip differs")

    # 4. COCO results of the full-width PoseNet's people (run_pose's setting).
    topology = "BODY_25"
    parts, pairs = pose.lookup_topology(topology)
    wide = pose.init_posenet(torch.Generator().manual_seed(0), topology, device=device)
    frames = torch.from_numpy(np.random.default_rng(1).random((COCO_SCENES,) + WIDE_HW + (3,), dtype=np.float32))
    with torch.no_grad():
        paf, hm = wide(frames.to(device).permute(0, 3, 1, 2).contiguous())
    people = []
    for b in range(COCO_SCENES):  # each frame's maps scaled to a unit maximum, as run_pose decodes them
        mp = pose._merge([paf[b]], (WIDE_HW[0] // 8, WIDE_HW[1] // 8))
        mh = pose._merge([hm[b, :len(parts)]], WIDE_HW)
        people.append(pose.decode_people(mp / mp.abs().amax(), mh / mh.amax(), pairs, num_parts=len(parts),
                                         paf_stride=8.0))
    results = savers.coco_keypoint_results(range(COCO_SCENES), [p.keypoints for p in people],
                                           [p.mask for p in people], [p.score for p in people])
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "coco.json"
        savers.save_coco_json(path, results)
        back = savers.load_coco_json(path)
        savers.save_heatmaps(Path(d) / "hm.npz", hm)
        hm_same = np.array_equal(savers.load_heatmaps(Path(d) / "hm.npz"), hm.cpu().numpy())
    per_image = savers.coco_results_to_keypoints(back)
    ok = back == results and hm_same
    for b, p in enumerate(people):
        m = p.mask.cpu().numpy()
        kp = p.keypoints.cpu().numpy()[m][:, savers.coco_order_indexes(len(parts))]
        if m.any():
            got = per_image[b]
            ok = ok and np.array_equal(got[0], kp[..., :2]) and np.array_equal(got[1], kp[..., 2] > 0)
    print(f"COCO results of {len(results)} people over {COCO_SCENES} full-width {topology} frames: written, read "
          f"back and inverted equal {ok}; heatmaps {tuple(hm.shape)} npz equal {hm_same}")
    require(ok and len(results) > 0, "COCO results or heatmaps differ after the round trip")

    # 5. The tools: the TUM fixture under build/ against the committed one,
    # the held-out tables on the card against the committed FIXTURES.md.
    run_tum_fixture_tool()
    run_robustness_tool()
    print(f"leaves: {time.perf_counter() - t_phase:.1f} s")


def fixtures_rows(path):
    """FIXTURES.md's table rows: (family, numbers) in file order."""
    rows = []
    for line in path.read_text().splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if line.startswith("| ") and cells[0] != "family":
            rows.append((cells[0], [float(c) for c in cells[1:]]))
    return rows


def run_robustness_tool():
    """``tools_torch/fixtures_robustness.py`` on the card (the JAX tool's
    keys), its tables held to the committed FIXTURES.md (the JAX tool's
    run; the CPU run of the port's tool equals it row for row,
    tests/test_torch_fixtures_robustness.py): the same families, each
    number within ROBUST_TOL of the committed one (the card's convolutions
    round otherwise, and a scene's keypoint may cross a threshold)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    out = root / "build" / "FIXTURES.md"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(root / "tools_torch" / "fixtures_robustness.py"), "--out", str(out)],
                   check=True, timeout=600, capture_output=True)
    got, want = fixtures_rows(out), fixtures_rows(root / "FIXTURES.md")
    worst = max((abs(a - b) for (_, x), (_, y) in zip(got, want) for a, b in zip(x, y)), default=float("inf"))
    same = sum(x == y for (_, x), (_, y) in zip(got, want))
    print(f"fixtures_robustness on the card: {len(got)} rows in {time.perf_counter() - t0:.1f} s, {same} equal to "
          f"the committed FIXTURES.md at its two decimals, the rest within {worst:.3f}")
    require([n for n, _ in got] == [n for n, _ in want] and worst <= ROBUST_TOL,
            "fixtures_robustness: the card's tables differ from FIXTURES.md")


def run_tum_fixture_tool():
    """``tools_torch/make_tum_fixture.py`` writes the 30-frame fixture under
    build/; it is held to the committed ``tests/fixtures/tum_mini``: the
    frame lists and calibration equal, the ground truth within 5e-6 (its
    sixth decimals differ by up to 3), depth within one count (0.2 mm).
    The committed fixture predates the current scene code: the JAX tool's
    output today differs from it the same way, and its colour frames by up
    to 169 grey levels (another room texture), which is printed, not
    held; the port's tool equals the JAX tool's output bit for bit
    (tests/test_torch_examples_geometry.py)."""
    from pathlib import Path

    from perception_tpu_torch.io.png import read_png

    root = Path(__file__).resolve().parent
    out, ref = root / "build" / "tum_mini", root / "tests" / "fixtures" / "tum_mini"
    subprocess.run([sys.executable, str(root / "tools_torch" / "make_tum_fixture.py"), "--out", str(out)],
                   check=True, timeout=300)
    text = all((out / f).read_text() == (ref / f).read_text() for f in ("rgb.txt", "depth.txt", "calibration.txt"))
    gt = [np.loadtxt(d / "groundtruth.txt") for d in (out, ref)]
    gt_diff = max_diff(*gt) if gt[0].shape == gt[1].shape else float("inf")
    diffs = {kind: max(max_diff(read_png(a), read_png(b)) for a, b in
                       zip(sorted((out / kind).glob("*.png")), sorted((ref / kind).glob("*.png"))))
             for kind in ("depth", "rgb")}
    print(f"make_tum_fixture: lists and calibration equal to the committed fixture {text}; ground truth within "
          f"{gt_diff:.1e}; depth within {diffs['depth']:.0f} counts; colour frames differ by up to "
          f"{diffs['rgb']:.0f} (not held)")
    require(text and gt_diff <= 5e-6 and diffs["depth"] <= 1, "make_tum_fixture: differs from the committed fixture")


def cli_call(argv):
    """``perception_tpu_torch.cli.main(argv)`` with the kernels' launch
    counts set to 0 just before and read just after, its stdout captured:
    (its JSON lines, seconds to the end of its device work, launches)."""
    from perception_tpu_torch import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")], seconds, counts


def pose_diff(poses, want):
    """(max translation distance m, max rotation entry difference) of two (N, 4, 4) stacks."""
    poses, want = np.asarray(poses, np.float64), np.asarray(want, np.float64)
    return (float(np.linalg.norm(poses[:, :3, 3] - want[:, :3, 3], axis=-1).max()),
            float(np.abs(poses[:, :3, :3] - want[:, :3, :3]).max()))


def run_cli(device, scene):
    """The command line from files, as a user runs it (README), through
    ``perception_tpu_torch.cli.main``, on files this phase writes into a
    temporary directory; the native host library is required (its build
    raises). Returns the K1 launches of the counted ``cuboid`` and
    ``objects`` calls.

    - ``cuboid``: the 8 bench frames as 16-bit mm PNGs (``--depth-scale
      0.001``), the template as ascii and as binary PCD: 8/8 accepted
      within 2 cm each time, one K1 launch a call.
    - ``objects``: the 640x480 clutter scene as a mm PNG, each class's
      captured template as a binary PCD, at the CLI's defaults
      (``ObjectConfig()``, ``--seed 0``): success, size difference and
      cluster sizes ``OBJ_CLI_JAX_REFERENCE``'s (the JAX CLI on the same
      files), the chamfer error within 0.05 cm of its and on the same
      side of 1 cm; ``detect_object`` on the decoded depth in memory gives
      the CLI's answer and the reference's winning cluster (the CLI's
      JSON has no cluster id); one K1 launch a call.
    - ``odometry --tum`` and ``slam --tum``: the SLAM scene's sweep
      written by ``bench/tum_sequence.py`` at 640x480 (its first
      CLI_FRAMES frames), the files read frame by frame as the JAX
      CLI reads them: ATE (aligned, as the CLI reports it) at most 2 cm,
      the ``--out`` trajectory read back by ``read_trajectory`` with the
      sequence's timestamps, its poses within CLI_POSE_TOL of
      ``run_odometry`` / ``run_slam`` on the same decoded arrays in
      memory (the file rounds to 1e-6), no kernel launch (default
      configurations: the op graph).
    - ``pose --image``: a fixture scene as an 8-bit PNG: the people of
      ``--out-json`` equal those of the facade on the decoded image.
    Prints frames/s from files, the PNG decode ms a frame (native, and
    numpy for one depth frame), and the sequence's read + decode rate in
    turns in order and through the native read-ahead
    (``runtime.FramePrefetcher``, decoding on the caller's thread)."""
    import tempfile
    from pathlib import Path

    from perception_tpu_torch import runtime
    from perception_tpu_torch.bench.clutter_scene import captured_template, render_depth_clutter, standard_clutter_poses
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.bench.tum_sequence import write_tum_sequence
    from perception_tpu_torch.geometry.camera import PinholeCamera, depth_from_u16
    from perception_tpu_torch.io.pcd import write_pcd
    from perception_tpu_torch.io.png import decode_png, encode_png, read_png, write_png
    from perception_tpu_torch.io.tum import TumSequence, read_trajectory, sequence_camera
    from perception_tpu_torch.models.objects import ObjectConfig, detect_object
    from perception_tpu_torch.models.pose_data import render_people, sample_skeletons
    from perception_tpu_torch.models.pose_fixture import FIXTURE_HW, FIXTURE_TOPOLOGY
    from perception_tpu_torch.models.slam.odometry import OdometryConfig, run_odometry
    from perception_tpu_torch.models.slam.system import SlamConfig, run_slam
    from perception_tpu_torch.wrapper import Perception, WrapperStructPose

    t_phase = time.perf_counter()
    runtime.build_native()
    require(runtime.native_available(), "the native host library is not available")
    print(f"native host library: {runtime.library_path().name}, native_available() {runtime.native_available()}")
    launches = {"cuboid": 0, "objects": 0}
    none = {"ransac_score": 0, "icp_gn": 0, "voxelhash_query": 0}
    one_k1 = dict(none, ransac_score=1)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # cuboid: PNG + PCD (ascii and binary), one call a frame.
        camera = PinholeCamera.d435_depth()
        depths, gts = bench_frames(camera, range(FRAMES))
        tmpl = benchmark_template()
        write_pcd(tmp / "ascii.pcd", tmpl)
        write_pcd(tmp / "binary.pcd", tmpl, binary=True)
        require(np.array_equal(runtime.read_pcd_native(tmp / "binary.pcd"), tmpl), "native binary PCD read")
        for i in range(FRAMES):
            write_png(tmp / f"bench{i}.png", np.clip(depths[i] * 1000.0, 0, 65535).astype(np.uint16))
        for kind in ("ascii", "binary"):
            errs, fits = [], []
            for i in range(FRAMES):
                out, _, counts = cli_call(["cuboid", "--depth", tmp / f"bench{i}.png", "--depth-scale", "0.001",
                                           "--template", tmp / f"{kind}.pcd"])
                require(counts == one_k1, f"cli cuboid: launches {counts}, expected one K1 launch")
                launches["cuboid"] += counts["ransac_score"]
                res = out[-1]
                errs.append(float(np.linalg.norm(np.asarray(res["pose"])[:3, 3] - gts[i][:3, 3])))
                fits.append(res["fitness"])
                require(res["accepted"], f"cli cuboid ({kind} template): frame {i} not accepted")
            print(f"cli cuboid ({kind} PCD template, mm PNGs): {FRAMES}/{FRAMES} accepted, translation error mm "
                  f"{np.round(np.array(errs) * 1e3, 2).tolist()}, fitness max {max(fits):.3e}, one K1 launch a call")
            require(max(errs) <= 0.02, f"cli cuboid ({kind} template): translation error over 2 cm")

        # objects: the clutter scene at 640x480, each class's template.
        poses = standard_clutter_poses()
        write_png(tmp / "clutter.png",
                  np.clip(render_depth_clutter(camera, poses, seed=3) * 1000.0, 0, 65535).astype(np.uint16))
        depth = torch.from_numpy(depth_from_u16(read_png(tmp / "clutter.png"), 0.001)).to(device)
        pts, mask = camera.backproject_depth(depth)
        for name in OBJ_CLASSES:
            t = captured_template(name, camera)
            write_pcd(tmp / f"{name}.pcd", t, binary=True)
            out, sec, counts = cli_call(["objects", "--depth", tmp / "clutter.png", "--template", tmp / f"{name}.pcd"])
            require(counts == one_k1, f"cli objects {name}: launches {counts}, expected one K1 launch")
            launches["objects"] += counts["ransac_score"]
            res = out[-1]
            err = chamfer_cm(t, np.asarray(res["pose"], np.float64), poses[name])
            mem = detect_object(pts, mask, torch.from_numpy(t).to(device),
                                torch.ones(len(t), dtype=torch.bool, device=device),
                                torch.Generator(device=device).manual_seed(0), ObjectConfig())
            mem = type(mem)(*(x.cpu() for x in mem))
            same = (res["success"] == bool(mem.success) and res["size_diff"] == int(mem.size_diff)
                    and res["cluster_sizes"] == mem.cluster_sizes.tolist())
            dt = float(np.linalg.norm(np.asarray(res["pose"])[:3, 3] - mem.pose[:3, 3].numpy()))
            success, cluster, diff, sizes, ref_err = OBJ_CLI_JAX_REFERENCE[name]
            print(f"cli objects [{name}]: success {res['success']}, cluster {int(mem.cluster_id)} (in memory), size "
                  f"diff {res['size_diff']}, clusters {res['num_clusters']} sizes {res['cluster_sizes']}, chamfer "
                  f"{err:.3f} cm; JAX CLI: cluster {cluster}, size diff {diff}, sizes {sizes}, chamfer {ref_err} cm; "
                  f"in memory: same answer {same}, translation diff {dt * 1e3:.4f} mm; {sec:.2f} s a call")
            require(same and dt <= 1e-3, f"cli objects {name}: the CLI and the in-memory call disagree")
            require((res["success"], int(mem.cluster_id), res["size_diff"], res["cluster_sizes"])
                    == (success, cluster, diff, sizes), f"cli objects {name}: the answer differs from the JAX CLI's")
            require(abs(err - ref_err) <= 0.05 and (ref_err >= 1.0) == (err >= 1.0),
                    f"cli objects {name}: chamfer {err:.3f} cm against the JAX CLI's {ref_err} cm")

        # The SLAM scene's sweep as a TUM sequence.
        cam, gt, grays, depths_s = scene
        seq_dir = tmp / "sweep"
        t0 = time.perf_counter()
        write_tum_sequence(seq_dir, cam, list(gt[:CLI_FRAMES]), render=lambda i: (grays[i], depths_s[i]))
        n_files = len(list(seq_dir.glob("*/*.png")))
        print(f"TUM sweep: {CLI_FRAMES} frames at {cam.width}x{cam.height} written in {time.perf_counter() - t0:.1f} s "
              f"({n_files} PNGs, {sum(f.stat().st_size for f in seq_dir.rglob('*')) / 2**20:.1f} MiB)")
        seq = TumSequence(seq_dir)
        blobs = {kind: [(seq_dir / rows[1][0]).read_bytes() for rows in lst]
                 for kind, lst in (("depth", seq.depth_list), ("rgb", seq.rgb_list))}
        decode_ms = {}
        for kind, color in (("depth", False), ("rgb", True)):
            t0 = time.perf_counter()
            for b in blobs[kind]:
                decode_png(b, color=color)
            decode_ms[kind] = (time.perf_counter() - t0) * 1e3 / len(blobs[kind])
        t0 = time.perf_counter()
        for b in blobs["depth"][:3]:
            decode_png(b, native=False)
        decode_ms["depth numpy"] = (time.perf_counter() - t0) * 1e3 / 3
        filtered = {}
        frame16 = decode_png(blobs["depth"][0])
        for f in range(5):
            data = encode_png(frame16, filter_type=f)
            t0 = time.perf_counter()
            for _ in range(10):
                decode_png(data)
            filtered[f] = (time.perf_counter() - t0) * 1e2
        print(f"PNG decode (host, native unfilter): {decode_ms['depth']:.3f} ms a {cam.width}x{cam.height} "
              f"16-bit depth frame, "
              f"{decode_ms['rgb']:.3f} ms an RGB frame (means over {len(blobs['depth'])}); numpy unfilter "
              f"{decode_ms['depth numpy']:.3f} ms a depth frame; a depth frame with every row filtered None/Sub/Up/"
              f"Average/Paeth: {[round(filtered[f], 3) for f in range(5)]} ms")

        # The sequence's read + decode rate, in order and through the
        # read-ahead, in turns (in order, read-ahead, read-ahead, in order).
        files = []
        for i in range(len(seq)):
            files.append((seq_dir / seq.depth_list[i][1][0], False))
            files.append((seq_dir / seq.rgb_list[seq.rgb_of_depth[i]][1][0], True))
        read_rates = {True: [], False: []}
        for ahead in (False, True, True, False):
            t0 = time.perf_counter()
            if ahead:
                stream = runtime.FramePrefetcher([p for p, _ in files], threads=2, ring=8)
                for (_, color), raw in zip(files, stream):
                    decode_png(raw, color=color)
                stream.close()
            else:
                for p, color in files:
                    decode_png(p.read_bytes(), color=color)
            read_rates[ahead].append(len(seq) / (time.perf_counter() - t0))
        print(f"TUM sweep read + decode (depth and RGB, host): in order {[round(r, 2) for r in read_rates[False]]} "
              f"frames/s, through the native read-ahead {[round(r, 2) for r in read_rates[True]]} frames/s")

        rates = {}
        camera_s = sequence_camera(seq_dir)
        for cmd, frames in (("odometry", CLI_FRAMES), ("slam", CLI_FRAMES)):
            # In memory first, on the decoded arrays (it also warms the path for the timed CLI run).
            mem = list(seq.frames(0, frames))
            d = torch.from_numpy(np.stack([np.nan_to_num(f.depth) for f in mem])).to(device)
            if cmd == "odometry":
                mem_poses, _ = run_odometry(camera_s, d, OdometryConfig())
            else:
                g = torch.from_numpy(np.stack([f.rgb.mean(-1).astype(np.float32) for f in mem])).to(device)
                state, mem_poses, _ = run_slam(camera_s, d, g, SlamConfig())
                print(f"slam --tum in memory: keyframes {int(state.keyframes.count)}, loop closures "
                      f"{int(((state.edges.weight == 2.0) & state.edges.mask).sum())}")
            mem_poses = torch.stack(mem_poses).cpu().numpy()
            out, sec, counts = cli_call([cmd, "--tum", seq_dir, "--max-frames", frames, "--out", tmp / f"{cmd}.txt"])
            rates[cmd] = frames / sec
            ate_row = out[-1]
            print(f"cli {cmd} --tum: {ate_row}, {frames / sec:.2f} frames/s from files ({sec:.1f} s), "
                  f"launches {counts}")
            require(counts == none, f"cli {cmd}: kernel launches {counts}, expected none")
            require(ate_row.get("metric") == "ate_rmse_m" and ate_row["frames"] == frames
                    and ate_row["value"] <= 0.02, f"cli {cmd}: ATE over 2 cm or missing")
            ts, file_poses = read_trajectory(tmp / f"{cmd}.txt")
            want_ts = np.array([t for t, _ in seq.depth_list[:frames]])
            require(file_poses.shape == (frames, 4, 4) and np.array_equal(ts, want_ts),
                    f"cli {cmd}: the --out trajectory does not read back")
            dt, dr = pose_diff(file_poses, mem_poses)
            print(f"cli {cmd} --out against {'run_odometry' if cmd == 'odometry' else 'run_slam'} on the "
                  f"decoded arrays: translation diff max {dt * 1e3:.6f} mm, rotation entry diff max {dr:.3e}")
            require(dt <= CLI_POSE_TOL and dr <= CLI_POSE_TOL, f"cli {cmd}: file and in-memory poses differ")
            step_ms = 1e3 / rates[cmd]
            require(decode_ms["depth"] + decode_ms["rgb"] * (cmd == "slam") < step_ms,
                    f"cli {cmd}: PNG decode slower than a step ({step_ms:.2f} ms)")

        # pose: a fixture scene as an 8-bit PNG.
        img = render_people(sample_skeletons(np.random.default_rng(POSE_SEED), FIXTURE_HW), FIXTURE_HW)
        write_png(tmp / "people.png", np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))
        out, _, counts = cli_call(["pose", "--image", tmp / "people.png", "--out-json", tmp / "people.json"])
        require(counts == none, f"cli pose: kernel launches {counts}, expected none")
        doc = json.loads((tmp / "people.json").read_text())
        engine = Perception(pose=WrapperStructPose(topology=FIXTURE_TOPOLOGY, net_hw=FIXTURE_HW), device=device)
        ppl = engine.emplace_and_pop(read_png(tmp / "people.png", color=True).astype(np.float32) / 255.0).people
        keep = ppl.mask.cpu().numpy()
        want = ppl.keypoints.cpu().numpy()[keep].reshape(int(keep.sum()), -1)
        got = np.array([p["pose_keypoints_2d"] for p in doc["people"]]).reshape(len(doc["people"]), -1)
        kp = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        print(f"cli pose --image: {out[-1]}, --out-json people {len(doc['people'])}, in memory {int(keep.sum())}, "
              f"keypoints max diff {kp:.3e} px")
        require(len(doc["people"]) == out[-1]["people"] == int(keep.sum()) >= 1 and kp <= POSE_KP_TOL,
                "cli pose: the people differ from the in-memory facade's")

    print(f"cli frames/s from files: odometry {rates['odometry']:.2f}, slam {rates['slam']:.2f}; read + decode "
          f"frames/s in order / read-ahead: {statistics.median(read_rates[False]):.2f} / "
          f"{statistics.median(read_rates[True]):.2f}; native_available() {runtime.native_available()}")
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def bench_launches():
    """The kernel launches one ``cli bench`` makes, worked out from its loops
    (``bench/headline.py``, ``tracking_bench``, ``nn_crossover``), keyed as
    ``read_launch_shapes`` keys them. K1 once a cuboid call at N=8192,
    K=1024 (B=1: the warm-up call, then a warm pass and REPEATS timed
    passes of TIMED_FRAMES frames; B > 1: a first block, then the same
    passes of max(2, TIMED_FRAMES // B) blocks) and once a tracker step at
    N=24576 (a warm-up step and TRACKING_FRAMES timed); K3+K4 once a hash
    query (at each NN size, keyed (queries, map points): warm and cold each
    ``bench_ms``'s 2 + 10 calls and one agreement call); K2 none, since
    ``bench.py``'s SLAM configurations run odometry's op graph and map
    mode's shortlist."""
    from perception_tpu_torch.bench import headline

    k1 = {}
    for b in headline.BATCHES:
        per_pass = headline.TIMED_FRAMES if b == 1 else max(2, headline.TIMED_FRAMES // b)
        k1[(b, 8192, 1024)] = 1 + per_pass * (1 + headline.REPEATS)
    k1[(1, 24576, 1024)] = 1 + headline.TRACKING_FRAMES
    k3 = {tuple(size): 2 * (2 + 10 + 1) for size in headline.NN_SIZES}
    return {"ransac_score": k1, "icp_gn": {}, "voxelhash_query": k3}


def run_bench(device):
    """The port's headline benchmark through its user's entry point,
    ``cli.main(["bench"])``, in this process at ``bench.py``'s full sizes.
    Prints its JSON line and holds it, and its launches by shape, read just
    after the call, to ``bench_launches``; returns those launches."""
    from perception_tpu_torch.bench import headline

    torch.cuda.reset_peak_memory_stats(device)
    lines, seconds, counts = cli_call(["bench"])
    shapes = read_launch_shapes()
    peak = torch.cuda.max_memory_allocated(device)
    require(bool(lines), "cli bench printed no JSON line")
    line = lines[-1]
    print(json.dumps(line))
    print(f"cli bench: {seconds:.1f} s, peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated), "
          f"launches {counts}")
    extra = line["extra"]
    require(line["metric"] == headline.METRIC and line["unit"] == "frames/s", "cli bench: wrong metric")
    require(not any(k.endswith("_error") for k in extra), "cli bench: an *_error key")

    fps, spread = extra["fps_vs_batch"], extra["fps_spread_pct_vs_batch"]
    batches = {str(b) for b in headline.BATCHES}
    require(set(fps) == set(spread) == batches, f"cli bench: fps_vs_batch {fps}, spreads {spread}")
    # fps_vs_batch is rounded to 2 decimals (which can tie), the value to 3.
    best = str(extra["headline_batch"])
    require(fps[best] == max(fps.values()) and abs(line["value"] - fps[best]) <= 0.0055,
            "cli bench: the value is not the best batch's")
    runs = extra["cpu_baseline_runs"]
    med = statistics.median(runs)
    require(len(runs) == 3 and med > 0, "cli bench: not 3 CPU-baseline passes")
    # Both sides are rounded to 3 decimals: the value, the runs and the ratio.
    tol = 0.0005 + (0.0005 + line["vs_baseline"] * 0.0005) / med
    require(abs(line["vs_baseline"] - line["value"] / med) <= tol, "cli bench: vs_baseline is not value / CPU")

    # SLAM: run_slam_paths' bounds on the same three configurations.
    mm = extra["map_mode"]
    print(f"cli bench SLAM: ATE {extra['ate_cm']} / {extra['ate_cm_no_ba']} / {mm['ate_cm']} cm (BA, no BA, map "
          f"32768), loop closures {extra['loop_closures']}, BA runs {extra['ba_runs']}, keyframes "
          f"{extra['keyframes']} / {mm['keyframes']}")
    require(max(extra["ate_cm"], extra["ate_cm_no_ba"], mm["ate_cm"]) <= 2.0, "cli bench: SLAM ATE over 2 cm")
    require(extra["ba_runs"] > 0 and extra["loop_closures"] > 0, "cli bench: no BA run or no loop closure")
    require(extra["slam_frames"] == headline.SLAM_FRAMES and mm["map_budget"] == 32768, "cli bench: SLAM sizes")

    tr, fb = extra["objects_tracking"], extra["facade"]
    require(tr["frames"] == headline.TRACKING_FRAMES and tr["latched_pct"] >= 95.0,
            "cli bench: tracker latched under 95%")
    require(tr["median_err_cm"] <= 2.0 and tr["p90_err_cm"] <= 5.0,
            "cli bench: tracker median error over 2 cm or p90 over 5 cm")
    require(fb["faces_tracked"] == 3 and fb["frames"] == headline.FACADE_FRAMES,
            "cli bench: the facade did not track 3 faces")

    nn = extra["nn_crossover"]
    require([(r["nq"], r["m"]) for r in nn] == [tuple(s) for s in headline.NN_SIZES], "cli bench: NN sizes")
    require(all(r["agree_pct"] == r["agree_cold_pct"] == 100.0 for r in nn),
            "cli bench: the hash disagrees with the KD-tree")

    # K3+K4's launches by NN size: the kernel shape (padded queries, table rows) query() gives each size.
    size_of = {(args[1].shape[0], args[0].shape[0]): nq_m for nq_m, (args, _) in crossover_cases(device)}
    shapes["voxelhash_query"] = {size_of.get(key, key): n for key, n in shapes["voxelhash_query"].items()}
    want = bench_launches()
    print(f"cli bench launches by shape: {shapes}, expected {want}")
    require(shapes == want, f"cli bench: kernel launches by shape {shapes}, expected {want}")
    return shapes


PROFILE_STAGES = (  # benchmarks/profile_stages.py's stages, in its order
    "cuboid/backproject+compact", "cuboid/voxel+compact", "cuboid/ransac-plane", "cuboid/compact+cluster",
    "cuboid/icp(4x20)", "cuboid/FULL-pipeline", "odom/frame-features(640x480)", "odom/step-keyframe(2048x4096)",
    "odom/brute-NN(2048x4096)", "odom/brute-NN(2048x32768)", "odom/voxelhash-NN(2048x32768)", "odom/step-map32k",
)
STAGE_CALLS = 2 + profile_stages.REPS  # a stage's own first call, measure_stage's warm-up, REPS timed
STAGE_LAUNCHES = {  # stage -> its calls' K1-K4 launches by shape; every other stage launches none
    "cuboid/ransac-plane": {"ransac_score": {(1, 8192, 1024): STAGE_CALLS}},
    "cuboid/FULL-pipeline": {"ransac_score": {(1, 8192, 1024): STAGE_CALLS}},
    "odom/voxelhash-NN(2048x32768)": {"voxelhash_query": {(2048, 33792): STAGE_CALLS}},
}
SWEEP_CALLS = 8 + sweep_config.TIMED  # a variant's calls: one a scene, then the timed ones
# variant -> bench scenes the port accepts on the CPU with the same triplets (sweep_config.run_variant
# on the CPU, every variant 8 of 8, as the JAX script expects of base)
SWEEP_CPU_ACCEPTED = {name: 8 for name in ("base", "boxtmpl1k", "restarts4", "work8k", "iters14", "pre32k",
                                           "hyp512")}


def merged_launches(parts):
    """The sum of launch dicts {kernel: {shape: n}}, every kernel keyed."""
    out = {name: {} for name in KERNELS}
    for part in parts:
        for name, by_shape in part.items():
            for shape, n in by_shape.items():
                out[name][shape] = out[name].get(shape, 0) + n
    return out


def run_stage_profile(device):
    """``bench/profile_stages.run``: the JAX script's 12 stages at its sizes,
    each stage's row printed; each with ms, a counted GFLOP and MB, both
    shares present and at most 100% of the card's peaks; each stage's K1 /
    K3+K4 launches by shape (read over its calls) exactly ``STAGE_LAUNCHES``'
    and the phase's the sum of the stages'. Returns the phase's launches."""
    reset_launches()
    out = profile_stages.run(device)
    shapes = read_launch_shapes()
    print(f"{profile_stages.card_line(device)}; profile_stages on {out['device']}: peaks (f32 TFLOP/s, bf16 "
          f"TFLOP/s, HBM GB/s) = {out['peaks_f32_tflops_bf16_tflops_hbm_gbps']}")
    for line in profile_stages.rows(out):
        print(line)
    stages = out["stages"]
    require([st["name"] for st in stages] == list(PROFILE_STAGES),
            f"profile_stages: stages {[st['name'] for st in stages]}")
    require(out["peaks_f32_tflops_bf16_tflops_hbm_gbps"] is not None, "profile_stages: no peaks for this card")
    for st in stages:
        print(json.dumps({"stage": st["name"], "terms": st["terms"],
                          "launches": {k: {str(sh): n for sh, n in v.items()} for k, v in st["launches"].items()}}))
        name = st["name"]
        require(st["ms"] > 0 and st["flops"] > 0 and st["bytes_accessed"] > 0, f"{name}: no time or no count")
        require(st["mfu_f32_pct"] is not None and st["hbm_pct"] is not None, f"{name}: no share")
        require(0 < st["mfu_f32_pct"] <= 100 and 0 < st["hbm_pct"] <= 100, f"{name}: a share over 100%")
        require(st["launches"] == STAGE_LAUNCHES.get(name, {}),
                f"{name}: launches {st['launches']}, expected {STAGE_LAUNCHES.get(name, {})}")
    want = merged_launches(st["launches"] for st in stages)
    require(shapes == want, f"profile_stages: launches {shapes}, the stages' {want}")
    return shapes


def run_facade_profile(device):
    """``bench/facade_profile.run``: the facade's four extractor subsets on
    the 256x256 three-face scene, 60 frames each: the JAX script's rows,
    each with a time; no K1-K4 launch."""
    reset_launches()
    rows = facade_profile.run(device=device)
    counts = read_launches()
    require([r["config"] for r in rows] == [n for n, _ in facade_profile.SUBSETS], f"facade_profile: {rows}")
    require(all(list(r) == ["config", "ms_per_frame", "fps"] and r["ms_per_frame"] > 0 for r in rows),
            f"facade_profile: {rows}")
    require(not any(counts.values()), f"facade_profile launched kernels: {counts}")


def run_sweep_config(device):
    """``bench/sweep_config.run``: the seven CuboidConfig variants over the 8
    bench scenes; no variant may fail; each variant's acceptance count equal
    to the port's on the CPU for the same scenes and triplets
    (``SWEEP_CPU_ACCEPTED``); K1 SWEEP_CALLS launches a variant, at
    (1, 8192, 512) for hyp512 and (1, 8192, 1024) for the rest. Returns the
    launches by shape."""
    reset_launches()
    rows = sweep_config.run(device=device)
    shapes = read_launch_shapes()
    failed = [r for r in rows if "error" in r]
    require(not failed, f"sweep_config: failed variants {failed}")
    for r in rows:
        print(f"sweep_config {r['config']}: accepted {r['accepted']}")
        require(sum(r["accepted"]) == SWEEP_CPU_ACCEPTED[r["config"]],
                f"sweep_config {r['config']}: {sum(r['accepted'])} accepted, "
                f"{SWEEP_CPU_ACCEPTED[r['config']]} on the CPU")
    want = merged_launches({"ransac_score": {(1, 8192, cfg.ransac_hypotheses): SWEEP_CALLS}}
                           for _, cfg in sweep_config.variants())
    require(shapes == want, f"sweep_config: launches {shapes}, expected {want}")
    return shapes


# The decay rows this run drives: the sweep's one non-baseline decay at full length (the three rows take
# ~65 s on the card: python -m perception_tpu_torch.bench.decay_sweep; the baseline's configuration is
# cli bench's map row, run_bench).
DECAY_SMOKE = ("0.5",)
# decay_sweep config -> ((ATE cm low, high), (loop closures, keyframes, BA runs)). At decay 0.5 the card
# gave 0.47601 cm and the port's CPU 0.47579 and, with frame 0 one ulp up at 64 pixels, 0.47613; every
# run at every decay 32 / 35 / 34. The range spans decay 1.0's two rounding modes' spread (0.4700-0.5312,
# about 0.06 cm) around those values.
DECAY_ROWS = {"decay=0.5": ((0.46, 0.54), (32, 35, 34))}


def run_decay_sweep(device):
    """``bench/decay_sweep.run`` over ``DECAY_SMOKE``: 300-frame 640x480 SLAM
    runs, BA on, a 32k map: the JAX script's rows printed; each row's ATE
    within its range and its loop closures, keyframes and BA runs equal to
    ``DECAY_ROWS``' (map mode's ATE is bimodal under rounding, so never one
    value); no K1-K4 launch."""
    reset_launches()
    out = decay_sweep.run(list(DECAY_SMOKE), device=device)
    counts = read_launches()
    require([row["config"] for row, _ in out] == [f"decay={d}" for d in DECAY_SMOKE],
            f"decay_sweep: rows {[row for row, _ in out]}")
    for row, r in out:
        (lo, hi), want = DECAY_ROWS[row["config"]]
        got = (r["loop_closures"], r["keyframes"], r["ba_runs"])
        print(f"decay_sweep {row['config']}: ATE {r['ate_cm']} cm (range {lo}-{hi}), loop closures / keyframes / "
              f"BA runs {got} (expected {want}), {r['slam_fps']:.2f} frames/s")
        require(lo <= r["ate_cm"] <= hi, f"decay_sweep {row['config']}: ATE {r['ate_cm']} cm outside {lo}-{hi}")
        require(got == want, f"decay_sweep {row['config']}: closures / keyframes / BA runs {got}, expected {want}")
    require(not any(counts.values()), f"decay_sweep launched kernels: {counts}")


def json_times(t):
    """A kernel's times for the JSON line: ``ms`` the eager wrapper call,
    ``device_ms`` its device time by graph replay. No single PyTorch call
    computes any of the three functions (a range scan or a fused NN +
    system), so there is no library time."""
    return {"ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}


def phase(fn, *args):
    """Run one phase of the smoke run and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    # PyTorch's defaults (cuDNN in TF32): the package computes in float32 by
    # its own guard (``_tensor.fp32``), which every phase's card-against-CPU
    # check proves.
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    obj_scene = objects_scene()
    eraser_cpu = start_eraser_cpu(obj_scene)  # beside the whole run

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, KERNELS))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNELS, libs):
        build.load_library(name)
        print(f"{lib.relative_to(build.BUILD_DIR.parents[1])}:")
        print(lib.with_name(lib.name + ".log").read_text().strip())

    k1_err = phase(check_kernel, device)
    k2_err = phase(check_k2, device)
    k3_err = phase(check_k3, device)

    cuboid_b1_launches, cuboid_b8_launches = phase(run_slice, device)
    t0 = time.perf_counter()
    scene = slam_scene()
    print(f"SLAM scene: {SLAM_FRAMES} frames {scene[0].width}x{scene[0].height}, fx {scene[0].fx:.1f}, "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    odo_launches, odo_bench_k2, _ = phase(run_odometry_paths, device, scene)
    slam_launches = phase(run_slam_paths, device, scene)
    cli_launches = phase(run_cli, device, scene)
    del scene
    mode_launches = phase(run_cuboid_modes, device)
    obj_launches, obj_bench_launches, eraser = phase(run_objects, device, obj_scene, eraser_cpu)
    phase(run_tracker, device)
    phase(run_pose, device)
    phase(run_face, device)
    phase(run_facade, device)
    phase(run_person_tracker, device)
    leaf_plane_launches, leaf_surface_launches = phase(run_leaf_nodes, device)
    phase(run_3d_chain, device)
    train_flops = phase(run_training, device)
    phase(run_multichip, train_flops)
    example_k1 = phase(run_examples, device)
    bench = phase(run_bench, device)
    stages = phase(run_stage_profile, device)
    phase(run_facade_profile, device)
    sweep = phase(run_sweep_config, device)
    phase(run_decay_sweep, device)

    k1_times = phase(time_kernel, device)
    k2_times = phase(time_k2, device)
    k3_times = phase(time_k3, device)

    eraser_spread(**eraser)
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
            ("B=1 N=8192 K=1024 (cuboid, one frame a call; with cli cuboid's, the leaf nodes' ground planes, "
             "example 01's, cli bench's batch-1 frames, profile_stages' RANSAC and full-pipeline stages and "
             "sweep_config's six K=1024 variants)",
             cuboid_b1_launches + cli_launches["cuboid"] + leaf_plane_launches + example_k1[(1, 8192, 1024)]
             + bench["ransac_score"][(1, 8192, 1024)] + stages["ransac_score"][(1, 8192, 1024)]
             + sweep["ransac_score"][(1, 8192, 1024)], (1, 8192)),
            ("B=2 N=8192 K=1024 (cli bench's batch-2 blocks)", bench["ransac_score"][(2, 8192, 1024)], (2, 8192)),
            ("B=4 N=8192 K=1024 (cli bench's batch-4 blocks)", bench["ransac_score"][(4, 8192, 1024)], (4, 8192)),
            ("B=8 N=8192 K=1024 (cuboid batches: default, cc, p2p; with pcl_parity's one B=2 call and cli "
             "bench's batch-8 blocks)", cuboid_b8_launches + mode_launches + bench["ransac_score"][(8, 8192, 1024)],
             (8, 8192)),
            ("B=1 N=32768 K=1024 (detect_object; with objects_bench's, cli objects' and example 02's)",
             obj_launches + obj_bench_launches + cli_launches["objects"] + example_k1[(1, 32768, 1024)],
             (1, 32768)),
            ("B=1 N=24576 K=1024 (tracker: cli bench's tracker row)", bench["ransac_score"][(1, 24576, 1024)],
             (1, 24576)),
            ("B=1 N=8192 K=512 (surface_frame; with sweep_config's hyp512 variant)",
             leaf_surface_launches + sweep["ransac_score"][K1_SURFACE], K1_SURFACE),
            ("B=1 N=32768 K=256 (example 09: detect_object at 256 hypotheses)", example_k1[(1, 32768, 256)],
             (1, 32768, 256)),
            ("B=1 N=16384 K=1024 (example 12: the tracker at work_capacity 16384)", example_k1[(1, 16384, 1024)],
             (1, 16384, 1024)),
        )),
        *({
            "name": "icp_gn",
            "shape": shape,
            "route": "cuda",
            "source": "perception_tpu_torch/csrc/icp_gn.cu",
            "replaces": "perception_tpu/ops/pallas/icp_gn.py:223",
            "launches": launches,
            "max_abs_err": k2_err,
            **json_times(k2_times[nm]),
        } for shape, launches, nm in (
            ("R=1 N=4096 M=8192 (odometry keyframe mode on K2; with odometry_bench's)",
             odo_launches["icp_gn"] + odo_bench_k2[(1, 4096, 8192)], (4096, 8192)),
            ("R=1 N=2048 M=4096 (SLAM keyframe mode on K2)", slam_launches["icp_gn"], (2048, 4096)),
            ("R=1 N=8192 M=32768 (odometry_bench's large budget pair)", odo_bench_k2[(1, 8192, 32768)],
             (8192, 32768)),
        )),
        *({
            "name": "voxelhash_query",
            "shape": shape,
            "route": "cuda",
            "source": "perception_tpu_torch/csrc/voxelhash_query.cu",
            "replaces": "perception_tpu/ops/voxelhash.py:285 (K3), perception_tpu/ops/voxelhash.py:201 (K4)",
            "launches": launches,
            "max_abs_err": k3_err,
            **json_times(k3_times[key]),
        } for shape, launches, key in (
            ("2048 q, 33792 rows (odometry and SLAM map mode on the hash; with profile_stages' "
             "voxelhash-NN stage)",
             odo_launches["voxelhash_query"] + slam_launches["voxelhash_query"]
             + stages["voxelhash_query"][(2048, 33792)], (32768, 2048)),
            *((f"{nq} q, {m} map points (cli bench's NN crossover)", n, ("crossover", nq, m))
              for (nq, m), n in bench["voxelhash_query"].items()),
        )),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
