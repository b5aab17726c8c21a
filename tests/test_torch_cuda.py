"""The port on a CUDA card: its kernels against their plain versions, and
the cuboid pipeline and SLAM odometry against the port's CPU path. Every
test skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
the card is, which has no JAX; the tests' conftest imports jax, so run it
there with ``--noconftest`` (see README.md).

Tolerances: the kernel's counts equal the plain version's exactly (both
round each multiply and add separately), at K1's seven path shapes (B=2
and B=4 at N=8192 are ``cli bench``'s blocks) and at
K=1023, B=3 and N=777, on random points and on ``chip_smoke``'s edge
inputs (points exactly at +-tau, one ulp past, -0.0, NaN and +-inf, valid
and masked), one launch a call; every (point, hypothesis) pair of a launch
plan is scored once, whatever the plan's splits. Pipeline on the card against
the CPU with the same RANSAC triplets: same acceptance, translation
within 1 mm, fitness within rtol 5e-2 — CUDA's ``index_add_`` adds with
atomics, so a voxel centroid may move by an ulp and one point may cross
the RANSAC threshold. The fused GN system (K2): equal gate counts, M and
the gated d2 sum within rtol/atol 1e-4 (float sums in another order). The
voxel-hash query (K3+K4): bit-identical (both round each operation),
also at ``cli bench``'s NN crossover sizes on the crossover's clouds.
Both kernels split their scan over blocks (K2 the target axis, K3+K4 each
tile's window); the tests place equal minima in different splits or
pieces, where the lower index must win, tie -0.0 with +0.0, and repeat
launches 20 times for identical outputs.
Odometry on the card against the CPU: poses within 1 mm over 5 frames.
The SLAM front end on the card against the CPU: FAST keypoints, scores
and masks equal, angles within 1e-4, BRIEF descriptors within 2 differing
bits (``cos``/``sin`` round differently), Hamming matches equal on the
same descriptors; ``bundle_adjust`` within 1e-4; ``slam_step`` over the
20-frame 96x72 out-and-back scene with the same RANSAC triplets: the same
promotions, closures and BA runs, poses within 1 mm.
The objects slice: K1 at the detection service's shape (N=32768,
K=1024) bit-exact; ``euclidean_cluster`` on the card against the CPU in
both modes, labels and sizes equal (integer sums; the centroids' float
atomics within 1e-6); ``detect_object`` on the card against the CPU with
the same RANSAC triplets: success, cluster id and sizes equal, the pose
within 1 mm.
Map mode's first shortlist build from one state (at the first frame and
at a moved keyframe) equal to the CPU's, index for index. The PAF limb
sums on roots with ~200 limbs each: 20 calls bit-equal to each other and
to the CPU. ``Perception`` (480x640, BODY_25 at 368x368, three faces) and
``extract_people`` with both TF32 flags set True by the caller: the CPU's
maps, keypoints and face landmarks within the phase tolerances, and the
flags True after.
The pose and hand path, with TF32 off for cuDNN and cuBLAS: ``nms_heatmap``
on random maps and on a plateau with tied peaks equal to the CPU's
(positions within 1e-6); ``assemble_people`` equal; ``crop_image`` of a
[0, 255] image (a box larger than the crop, one partly outside) within
2e-4; the tiny trained PoseNet's maps within 1e-4 and its
``extract_people`` on 4 fixture scenes: the same people, keypoints within
1e-3 px.
The face family, the facade and the person tracker: ``chip_smoke``'s
single-face chain on 3 scenes (boxes and landmarks within 1e-3 px, the
same masks, head poses and AU intensities within 1e-4); the facade
(pose, 4 face slots, hands) on two 256x256 three-face frames (the same
people and slots, keypoints and face landmarks within 1e-3 px, head poses
within 1e-4, hand landmarks within 1e-2 px); ``tracker_step`` over 4
frames of ``person_scene`` (ids equal, keypoints within 1e-3 px), and its
slot collision repeated 20 times with one result.
The command line and its file I/O, on the card's host: the native host
library builds; the PNG decoder's native and numpy unfilters agree
bit for bit (no cv2 there); ``ImageDirectoryReader`` yields the same
frames with and without the prefetcher; ``cli odometry`` without
``--cpu`` runs every step on the card.
The leaf nodes and the 3-D chain: ``detect_red_object`` equal to the CPU
on a noisy 640x480 scene; ``estimate_surface_frame`` on the tabletop
scene with the same triplets, exactly 3 K1 launches, inlier counts equal
and the pose within 1e-5; ``triangulate`` within 1e-4 m with ``valid``
equal, and ``fit_body_from_body25`` within 1 mm of the CPU.
``points.segment_sum`` (the centroids' float sums): 20 calls on the card
equal to each other and to the CPU's in-order sums, bit for bit.
The training path: one ``make_train_step`` SGD step of the full-width
MPI_15 PoseNet at 368x368, B=8 (``chip_smoke.run_training``'s batch), on
the card against the CPU from the same weights and batch: the loss within
1e-5 relative, each gradient within 2e-3 of its tensor's largest, the
parameters after the step within 1e-6 (``chip_smoke.step_against_cpu``).
``roofline.measure_stage`` of a 512x256 by 256x128 matrix product: a
positive time by CUDA events, exactly 2 m n k operations, and shares of
the peaks on a card in its table.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.cuboid import (
    CuboidConfig,
    cuboid_pipeline_batch,
    decimate,
    ransac_input,
    template_features,
)
from perception_tpu_torch.bench.slam_scene import render_textured_room, sweep_trajectory
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.models.slam import system
from perception_tpu_torch.models.slam.backend import BAProblem, bundle_adjust
from perception_tpu_torch.models.slam.odometry import OdometryConfig, run_odometry
from perception_tpu_torch.ops import features
from perception_tpu_torch.ops import voxelhash
from perception_tpu_torch.ops.kernels import icp_gn
from perception_tpu_torch.ops.kernels.ransac_score import ransac_score, ransac_score_reference
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query, voxelhash_query_reference
from perception_tpu_torch.ops import ransac
from perception_tpu_torch.ops.ransac import _sample_indices


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_case(seed, b, n, k):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    normals = rng.randn(b, k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    hyp = np.concatenate([normals, rng.randn(b, k, 1).astype(np.float32) * 0.5], -1)
    return pts, mask, hyp


K1_BENCH_SHAPES = [(2, 8192, 1024), (4, 8192, 1024)]  # cli bench's batch-2 and batch-4 blocks
K1_SHAPES = [(1, 8192, 1024), (8, 8192, 1024), (1, 32768, 1024), (1, 24576, 1024), (1, 8192, 512),
             (3, 777, 100), (1, 8192, 1023), (2, 777, 100), (3, 1, 1), *K1_BENCH_SHAPES]


@pytest.mark.parametrize("b,n,k", K1_SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, k):
    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(b, b, n, k))
    before, shape_before = ransac_score.launches, ransac_score.launches_by_shape[(b, n, k)]
    got = ransac_score(pts, mask, hyp, 0.05)
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    assert ransac_score.launches_by_shape[(b, n, k)] == shape_before + 1
    assert torch.equal(got, ransac_score_reference(pts, mask, hyp, 0.05))


@pytest.mark.parametrize("b,n,k", K1_SHAPES[:7] + K1_BENCH_SHAPES)
def test_cuda_kernel_matches_plain_version_on_edge_inputs(cuda_device, b, n, k):
    from chip_smoke import TAU, k1_edge_inputs

    pts, mask, hyp = k1_edge_inputs(b, n, k, cuda_device, seed=b + n + k)
    before = ransac_score.launches
    got = ransac_score(pts, mask, hyp, TAU)
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    assert torch.equal(got, ransac_score_reference(pts, mask, hyp, TAU))


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_cuda_kernel_is_the_same_under_any_plan(cuda_device, monkeypatch, sms):
    """The plan's splits (from 1 to one per chunk) change no count, and an
    all-masked frame scores 0."""
    from perception_tpu_torch.ops.kernels import ransac_score as k1

    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(9, 3, 4000, 300))
    mask[1] = False
    monkeypatch.setattr(k1, "sm_count", lambda index: sms)
    got = ransac_score(pts, mask, hyp, 0.05)
    assert torch.equal(got, ransac_score_reference(pts, mask, hyp, 0.05))
    assert not got[1].any()


def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(0, 1, 64, 8))
    with pytest.raises(TypeError):
        ransac_score(pts.double(), mask, hyp, 0.05)
    with pytest.raises(ValueError):
        ransac_score(pts.transpose(1, 2).contiguous(), mask, hyp, 0.05)
    with pytest.raises(ValueError):
        ransac_score(pts, mask.cpu(), hyp, 0.05)


def test_cuda_pipeline_matches_cpu_with_same_triplets(cuda_device):
    cfg = CuboidConfig()
    camera = PinholeCamera.d435_depth()
    tnp = benchmark_template()
    depths, gts = bench_frames(camera, (1, 5))
    depths = torch.from_numpy(depths)
    d, cam2 = decimate(depths, camera, cfg.depth_stride)
    _, dm = ransac_input(*cam2.backproject_depth(d), cfg)
    idx = _sample_indices(torch.Generator().manual_seed(3), dm, cfg.ransac_hypotheses)
    res = {}
    for dev in ("cpu", cuda_device):
        t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=dev)
        out = cuboid_pipeline_batch(depths.to(dev), camera, t, tm, None, cfg,
                                    template_normals=tn, indices=idx)
        res[str(dev)] = type(out)(*(x.cpu() for x in out))
    c, g = res["cpu"], res[str(cuda_device)]
    assert torch.equal(c.accepted, g.accepted) and bool(g.accepted.all())
    assert float((c.pose[:, :3, 3] - g.pose[:, :3, 3]).norm(dim=-1).max()) <= 1e-3
    np.testing.assert_allclose(g.fitness.numpy(), c.fitness.numpy(), rtol=5e-2)
    err = np.linalg.norm(g.pose[:, :3, 3].numpy() - gts[:, :3, 3], axis=-1)
    assert np.all(err <= 0.02)


def gn_case(seed, r, n, m, device, all_masked=False):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy((rng.randn(r, n, 3) * 0.3).astype(np.float32))
    smask = torch.from_numpy(np.zeros((r, n), bool) if all_masked else rng.rand(r, n) > 0.1)
    tgt = torch.from_numpy((rng.randn(m, 3) * 0.3).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.from_numpy(rng.randn(m, 3).astype(np.float32)), dim=1)
    tgtd, tn = icp_gn.pack_target(tgt, nrm, torch.from_numpy(rng.rand(m) > 0.1))
    Ts = se3.se3_exp(torch.from_numpy((rng.randn(r, 6) * 0.02).astype(np.float32)))
    return tuple(t.to(device) for t in (icp_gn.pack_source(src, smask), tgtd, tn, Ts))


@pytest.mark.parametrize("r,n,m,all_masked", [(1, 4096, 8192, False), (3, 217, 100, False), (1, 512, 1024, True)])
def test_cuda_icp_gn_matches_plain_version(cuda_device, r, n, m, all_masked):
    args = gn_case(r + n, r, n, m, cuda_device, all_masked)
    before = icp_gn.gn_system_packed.launches
    M, st = icp_gn.gn_system_packed(*args, 0.25, 0.02, return_stats=True)
    torch.cuda.synchronize()
    assert icp_gn.gn_system_packed.launches == before + 1
    Mr, sr = icp_gn.gn_system_reference(*args, 0.25, 0.02)
    assert torch.equal(st[:, 0], sr[:, 0])
    assert torch.allclose(M, Mr, rtol=1e-4, atol=1e-4)
    assert torch.allclose(st[:, 1], sr[:, 1], rtol=1e-4, atol=1e-4)
    assert all_masked == (not M.any())


def test_cuda_icp_gn_rejects_what_it_cannot_take(cuda_device):
    src8, tgtd, tn, Ts = gn_case(0, 1, 64, 32, cuda_device)
    with pytest.raises(TypeError):
        icp_gn.gn_system_packed(src8.double(), tgtd, tn, Ts, 0.25, 0.02)
    with pytest.raises(ValueError):
        icp_gn.gn_system_packed(src8, tgtd[:, :4].contiguous(), tn, Ts, 0.25, 0.02)
    with pytest.raises(ValueError):
        icp_gn.gn_system_packed(src8, tgtd.cpu(), tn, Ts, 0.25, 0.02)


def test_cuda_icp_gn_ties_across_splits_keep_the_lower_index(cuda_device):
    """Sources sitting exactly on targets that have an exact copy (with
    another normal) in a later split, and a source at the origin between
    targets at (-0, 0, 0) and (0, -0, 0): the lower index must win, as in
    the plain version, or M takes the other normal."""
    r, n, m = 1, 512, 4096
    plan = icp_gn.launch_plan(r, n, m, icp_gn.sm_count(cuda_device.index or 0))
    first = np.arange(64) * 3                                   # the first splits
    copy = (plan.splits - 1) * plan.split_rows + np.arange(64)  # the last split
    assert copy[0] // plan.split_rows > first[-1] // plan.split_rows and 2000 // plan.split_rows > 0
    rng = np.random.RandomState(5)
    tgt = (rng.randn(m, 3) * 0.3).astype(np.float32)
    nrm = rng.randn(m, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    src = (rng.randn(r, n, 3) * 0.3).astype(np.float32)
    tgt[copy] = tgt[first]
    src[0, :64] = tgt[first]
    tgt[5], tgt[2000] = (-0.0, 0.0, 0.0), (0.0, -0.0, 0.0)  # splits 0 and 2000 // split_rows
    src[0, 64] = 0.0
    tgtd, tn = icp_gn.pack_target(torch.from_numpy(tgt), torch.from_numpy(nrm), torch.ones(m, dtype=torch.bool))
    src8 = icp_gn.pack_source(torch.from_numpy(src), torch.ones((r, n), dtype=torch.bool))
    Ts = torch.eye(4).expand(r, 4, 4).contiguous()
    args = tuple(t.to(cuda_device) for t in (src8, tgtd, tn, Ts))
    M, st = icp_gn.gn_system_packed(*args, 0.25, 0.02, return_stats=True)
    Mr, sr = icp_gn.gn_system_reference(*args, 0.25, 0.02)
    assert torch.equal(st[:, 0], sr[:, 0])
    assert torch.allclose(M, Mr, rtol=1e-4, atol=1e-4)
    # The copies' normals differ, so taking them would move M by far more.
    nrm_w = nrm.copy()
    nrm_w[first], nrm_w[5] = nrm[copy], nrm[2000]
    _, tn_w = icp_gn.pack_target(torch.from_numpy(tgt), torch.from_numpy(nrm_w), torch.ones(m, dtype=torch.bool))
    Mw, _ = icp_gn.gn_system_reference(args[0], args[1], tn_w.to(cuda_device), args[3], 0.25, 0.02)
    assert float((Mw - Mr).abs().max()) > 1e-2


@pytest.mark.parametrize("r,n,m", [(4, 1024, 1280), (2, 4096, 8192)])
def test_cuda_icp_gn_restarts_and_repeats(cuda_device, r, n, m):
    """R > 1 (the cuboid ICP's 4 restarts among them), and 20 launches
    give identical outputs."""
    args = gn_case(7, r, n, m, cuda_device)
    M, st = icp_gn.gn_system_packed(*args, 0.25, 0.02, return_stats=True)
    Mr, sr = icp_gn.gn_system_reference(*args, 0.25, 0.02)
    assert torch.equal(st[:, 0], sr[:, 0]) and bool((sr[:, 0] > 0).all())
    assert torch.allclose(M, Mr, rtol=1e-4, atol=1e-4)
    for _ in range(20):
        M2, st2 = icp_gn.gn_system_packed(*args, 0.25, 0.02, return_stats=True)
        assert torch.equal(M2, M) and torch.equal(st2, st)


def direct_query_case(device):
    """A 4096-row table and 256 queries in two tiles of 128, with the
    window cut into pieces: tile 0's queries sit on rows of piece 0 that
    have exact copies in a later piece; query 100 at the origin between
    rows (-0, 0, 0) and (0, -0, 0); tile 1's chunk count passes R // rblk
    (the window caps it)."""
    rng = np.random.RandomState(11)
    npad, tile, R, rblk = 4096, 128, 2048, 512
    table = np.zeros((npad, 8), np.float32)
    table[:, :3] = rng.uniform(-1, 1, (npad, 3))
    table[:, 3] = 1.0
    q = rng.uniform(-1, 1, (2 * tile, 3)).astype(np.float32)
    first, copy = np.arange(100), 1300 + np.arange(100)
    table[copy, :3] = table[first, :3]
    q[:100] = table[first, :3]
    table[200, :3], table[1500, :3] = (-0.0, 0.0, 0.0), (0.0, -0.0, 0.0)
    q[100] = 0.0
    start = torch.tensor([0, 1024], dtype=torch.int32)
    nchunk = torch.tensor([4, 5], dtype=torch.int32)
    return (torch.from_numpy(table).to(device), torch.from_numpy(q).to(device), start.to(device),
            nchunk.to(device), tile, R, rblk)


def test_cuda_voxelhash_query_ties_across_pieces_keep_the_lower_index(cuda_device):
    args = direct_query_case(cuda_device)
    plan = voxelhash_query_launch_plan(args, cuda_device)
    assert 1300 // plan.piece_rows > 99 // plan.piece_rows and 1500 // plan.piece_rows > 200 // plan.piece_rows
    idx, d2 = voxelhash_query(*args)
    ridx, rd2 = voxelhash_query_reference(*args)
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert idx[:100].tolist() == list(range(100)) and int(idx[100]) == 200


def voxelhash_query_launch_plan(args, device):
    from perception_tpu_torch.ops.kernels import voxelhash_query as vq

    table, q, start, nchunk, tile, R, rblk = args
    return vq.launch_plan(q.shape[0], tile, R, rblk, vq.sm_count(device.index or 0))


@pytest.mark.parametrize("m,all_masked", [(32768, False), (32768, True)])
def test_cuda_voxelhash_query_masked_and_repeats(cuda_device, m, all_masked):
    """An all-masked map (every row at the sentinel), and 20 launches give
    identical outputs."""
    rng = np.random.RandomState(3)
    ref = torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(np.float32)).to(cuda_device)
    q = ref[torch.from_numpy(rng.randint(0, m, 2048)).to(cuda_device)]
    vh = voxelhash.build(ref, torch.full((m,), not all_masked, device=cuda_device), 0.06)
    q, _ = voxelhash.sort_by_cell(vh, q)
    args, _ = voxelhash.kernel_args(vh, q)
    idx, d2 = voxelhash_query(*args)
    ridx, rd2 = voxelhash_query_reference(*args)
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert all_masked == bool((rd2 > 1e11).all())
    for _ in range(20):
        idx2, d22 = voxelhash_query(*args)
        assert torch.equal(idx2, idx) and torch.equal(d22, d2)


@pytest.mark.parametrize("m,nq,order", [(32768, 2048, "sorted"), (65536, 4096, "sorted"), (32768, 1000, "caller")])
def test_cuda_voxelhash_query_matches_plain_version(cuda_device, m, nq, order):
    rng = np.random.RandomState(m + nq)
    ref = torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(np.float32)).to(cuda_device)
    q = ref[torch.from_numpy(rng.randint(0, m, nq)).to(cuda_device)] + 0.01 * torch.from_numpy(
        rng.randn(nq, 3).astype(np.float32)).to(cuda_device)
    vh = voxelhash.build(ref, torch.ones(m, dtype=torch.bool, device=cuda_device), 0.06)
    if order == "sorted":
        q, _ = voxelhash.sort_by_cell(vh, q)
    args, overflow = voxelhash.kernel_args(vh, q)
    before = voxelhash_query.launches
    idx, d2 = voxelhash_query(*args)
    torch.cuda.synchronize()
    assert voxelhash_query.launches == before + 1
    ridx, rd2 = voxelhash_query_reference(*args)
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert (float(overflow) > 0) == (order == "caller")


@pytest.mark.parametrize("size", [(4096, 8192), (16384, 131072), (307200, 32768)])
def test_cuda_voxelhash_query_at_the_bench_crossover_sizes(cuda_device, size):
    """The kernel at cli bench's NN crossover sizes, on the crossover's own
    clouds and in its query order (``chip_smoke.crossover_cases``): one
    launch a call, counted at its (padded queries, table rows),
    bit-identical to the plain version; the table of 131072 points is past
    49152 rows (the 128-row alignment regime)."""
    from chip_smoke import crossover_cases

    (args, _), = [case for nq_m, case in crossover_cases(cuda_device) if nq_m == size]
    shape = (args[1].shape[0], args[0].shape[0])
    before, shape_before = voxelhash_query.launches, voxelhash_query.launches_by_shape[shape]
    idx, d2 = voxelhash_query(*args)
    torch.cuda.synchronize()
    assert voxelhash_query.launches == before + 1
    assert voxelhash_query.launches_by_shape[shape] == shape_before + 1
    ridx, rd2 = voxelhash_query_reference(*args)
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)


@pytest.mark.parametrize("mode", ["fused", "hash"])
def test_cuda_odometry_matches_cpu(cuda_device, mode):
    w, h = 160, 120
    fx = 307.0 * w / 320.0
    cam = PinholeCamera.from_K([fx, 0, w / 2, 0, fx, h / 2, 0, 0, 1], width=w, height=h)
    depths = torch.from_numpy(np.stack([render_textured_room(cam, T, seed=i)[1]
                                        for i, T in enumerate(sweep_trajectory(n=300)[:5])]))
    kw = dict(point_budget=1024, keyframe_budget=2048, icp_iterations=6, normal_max_edge=0.2)
    cfg = (OdometryConfig(**kw, fused_gn="on") if mode == "fused"
           else OdometryConfig(**kw, map_budget=8192, map_nn="hash", map_nn_radius=0.1))
    launches = (icp_gn.gn_system_packed.launches, voxelhash_query.launches)
    gpu, _ = run_odometry(cam, depths.to(cuda_device), cfg)
    cpu, _ = run_odometry(cam, depths, cfg)
    torch.cuda.synchronize()
    k2, k3 = (icp_gn.gn_system_packed.launches - launches[0], voxelhash_query.launches - launches[1])
    assert (k2, k3) == ((4 * 6, 0) if mode == "fused" else (0, 4 * 7))
    gpu, cpu = torch.stack(gpu).cpu(), torch.stack(cpu)
    assert float((gpu[:, :3, 3] - cpu[:, :3, 3]).norm(dim=-1).max()) <= 1e-3


def small_slam_scene():
    """The 96x72 camera and 20-frame out-and-back trajectory of the SLAM
    system tests, rendered by the port's scene (no JAX here)."""
    cam = PinholeCamera.from_K([60.0, 0, 48, 0, 60.0, 36, 0, 0, 1], width=96, height=72)
    gt = []
    for k in range(20):
        dist = (k if k <= 9.5 else 19 - k) * (0.5 / 9.5)
        tw = torch.tensor([dist, 0.0, 0.0, 0.0, 0.02 * np.sin(np.pi * k / 19), 0.0])
        gt.append(se3.se3_exp(tw).numpy())
    frames = [render_textured_room(cam, T, seed=i) for i, T in enumerate(gt)]
    cfg = system.SlamConfig(
        odometry=OdometryConfig(point_budget=1024, keyframe_budget=2048, icp_iterations=8, min_depth=0.1,
                                max_depth=6.0, normal_max_edge=0.5, kf_translation=0.08, kf_rotation=0.1),
        max_keyframes=16, max_edges=40, features_per_kf=128, fast_threshold=15.0, lc_min_gap=2,
        lc_min_matches=15, lc_min_inliers=8,
    )
    grays = torch.from_numpy(np.stack([g for g, _ in frames]))
    depths = torch.from_numpy(np.stack([d for _, d in frames]))
    return cam, cfg, grays, depths


def test_cuda_features_match_cpu(cuda_device):
    _, _, grays, _ = small_slam_scene()
    gray = grays[0]
    out = {}
    for dev in ("cpu", cuda_device):
        kps = features.fast_detect(gray.to(dev), threshold=15.0, max_keypoints=128)
        desc = features.brief_describe(gray.to(dev), kps)
        out[str(dev)] = [t.cpu() for t in (*kps, desc)]
    (uv, score, angle, mask, desc), (guv, gscore, gangle, gmask, gdesc) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(uv, guv) and torch.equal(mask, gmask) and int(mask.sum()) > 20
    assert torch.allclose(gscore, score, rtol=1e-6, atol=0) and torch.allclose(gangle, angle, atol=1e-4, rtol=0)
    bits = features.popcount32(desc ^ gdesc).sum(dim=1)
    assert int(bits.max()) <= 2
    other = torch.roll(desc, 7, 0)
    m = [features.match_descriptors(desc.to(dev), mask.to(dev), other.to(dev), mask.to(dev), max_matches=128)
         for dev in ("cpu", cuda_device)]
    assert all(torch.equal(a, b.cpu()) for a, b in zip(*m))


def test_cuda_bundle_adjust_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    L, M = 60, 4
    lms = np.stack([rng.uniform(-1, 1, L), rng.uniform(-0.8, 0.8, L), rng.uniform(2.0, 4.0, L)], 1)
    poses = se3.se3_exp(torch.tensor([[0.3 * k, 0, 0, 0, 0.02 * k, 0] for k in range(M)])).numpy()
    obs = []
    for k in range(M):
        T_cw = np.linalg.inv(poses[k])
        pc = lms @ T_cw[:3, :3].T + T_cw[:3, 3]
        for l in range(L):
            uv = 525.0 * pc[l, :2] / pc[l, 2] + [319.5, 239.5] + rng.randn(2) * 0.3
            obs.append((k, l, *uv, pc[l, 2]))
    obs = np.array(obs)
    init = poses @ se3.se3_exp(torch.from_numpy((rng.randn(M, 6) * 0.02).astype(np.float32))).numpy()
    init[0] = poses[0]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    problem = BAProblem(f32(init), f32(lms + rng.randn(L, 3) * 0.02), torch.from_numpy(obs[:, 0].astype(np.int32)),
                        torch.from_numpy(obs[:, 1].astype(np.int32)), f32(obs[:, 2:4]),
                        torch.ones(len(obs), dtype=torch.bool), f32(obs[:, 4]), f32(525.0 / obs[:, 4]))
    res = [bundle_adjust(BAProblem(*(t.to(dev) for t in problem)), 525.0, 525.0, 319.5, 239.5, iterations=6)
           for dev in ("cpu", cuda_device)]
    c, g = res[0], type(res[1])(*(t.cpu() for t in res[1]))
    assert float(g.final_cost) < float(g.initial_cost)
    for a, b in zip(c, g):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)


def test_cuda_slam_step_matches_cpu(cuda_device, monkeypatch):
    cam, cfg, grays, depths = small_slam_scene()
    runs = {}
    for dev in ("cpu", cuda_device):
        draws = iter(range(1000))
        monkeypatch.setattr(system, "_draw_triplets", lambda g, m, k: ransac._sample_indices(
            torch.Generator().manual_seed(next(draws)), m.cpu(), k).to(m.device))
        before = icp_gn.gn_system_packed.launches
        state, poses, diags = system.run_slam(cam, depths.to(dev), grays.to(dev), cfg)
        flags = [(bool(d.promoted), int(d.loop_candidate), bool(d.ba_ran)) for d in diags]
        runs[str(dev)] = torch.stack(poses).cpu(), flags, icp_gn.gn_system_packed.launches - before
    (cpu, cflags, _), (gpu, gflags, launches) = runs["cpu"], runs[str(cuda_device)]
    assert cflags == gflags and launches == 0  # keyframe mode with the op graph
    assert sum(f[0] for f in cflags) >= 5 and sum(f[1] >= 0 for f in cflags) >= 1 and sum(f[2] for f in cflags) >= 1
    assert float((gpu[:, :3, 3] - cpu[:, :3, 3]).norm(dim=-1).max()) <= 1e-3


@pytest.mark.parametrize("refine", [False, True])
def test_cuda_euclidean_cluster_matches_cpu(cuda_device, refine):
    from perception_tpu_torch.ops.cluster import euclidean_cluster

    rng = np.random.RandomState(4)
    centres = rng.uniform(-0.3, 0.3, (8, 3))
    pts = torch.from_numpy((centres[rng.randint(0, 8, 8192)] + rng.randn(8192, 3) * 0.015).astype(np.float32))
    mask = torch.from_numpy(rng.rand(8192) > 0.1)
    cpu = euclidean_cluster(pts, mask, min_size=40, max_clusters=8, refine=refine)
    gpu = euclidean_cluster(pts.to(cuda_device), mask.to(cuda_device), min_size=40, max_clusters=8, refine=refine)
    assert torch.equal(gpu.labels.cpu(), cpu.labels) and torch.equal(gpu.sizes.cpu(), cpu.sizes)
    assert int(gpu.num_clusters) == int(cpu.num_clusters) >= 4
    assert torch.allclose(gpu.centroids.cpu(), cpu.centroids, atol=1e-6, rtol=0)


def test_cuda_detect_object_matches_cpu(cuda_device):
    from perception_tpu_torch.bench.clutter_scene import captured_template, render_depth_clutter, standard_clutter_poses
    from perception_tpu_torch.models.objects import ObjectConfig, detect_object, working_set

    cam = PinholeCamera.from_K([192.0, 0, 160.0, 0, 192.0, 120.0, 0, 0, 1], 320, 240)
    depth = torch.from_numpy(render_depth_clutter(cam, standard_clutter_poses(), seed=3))
    pts, mask = cam.backproject_depth(depth)
    cfg = ObjectConfig(cluster_min_size=20, work_capacity=8192, offplane_capacity=2048, cluster_capacity=512)
    tmpl = torch.from_numpy(captured_template("clamp", cam))
    _, dm, _ = working_set(pts, mask, cfg)
    idx = _sample_indices(torch.Generator().manual_seed(5), dm, cfg.ransac_hypotheses)
    before = ransac_score.launches
    res = [detect_object(pts.to(dev), mask.to(dev), tmpl.to(dev), torch.ones(len(tmpl), dtype=torch.bool, device=dev),
                         None, cfg, indices=idx) for dev in ("cpu", cuda_device)]
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    c, g = res[0], type(res[1])(*(t.cpu() for t in res[1]))
    for a, b in zip(c[:1] + c[3:], g[:1] + g[3:]):  # success, cluster id, size diff, count, sizes
        assert torch.equal(a, b)
    assert bool(g.success) and float((g.pose[:3, 3] - c.pose[:3, 3]).norm()) <= 1e-3


def test_cuda_nms_heatmap_matches_cpu(cuda_device):
    from perception_tpu_torch.ops.heatmap import nms_heatmap

    rng = np.random.default_rng(0)
    smooth = torch.nn.functional.avg_pool2d(torch.from_numpy(rng.random((25, 376, 376), dtype=np.float32))[None],
                                            9, stride=1)[0]
    plateau = torch.zeros(2, 16, 16)
    plateau[0, 5:7, 8:10] = 0.7
    plateau[0, 12, 3] = 0.9
    for i in range(6):
        plateau[1, 2 + 2 * (i // 3), 2 + 4 * (i % 3)] = 0.5
    for hm, thr, k in ((smooth, 0.5, 32), (plateau, 0.05, 4)):
        c = nms_heatmap(hm, threshold=thr, max_peaks=k)
        g = nms_heatmap(hm.to(cuda_device), threshold=thr, max_peaks=k)
        assert torch.equal(g.mask.cpu(), c.mask)
        assert int(c.mask.sum()) > 0
        assert torch.allclose(g.xy.cpu(), c.xy, rtol=0, atol=1e-6)
        assert torch.equal(g.score.cpu(), c.score)


def test_cuda_assemble_people_matches_cpu(cuda_device):
    from perception_tpu_torch.models.pose import MPI_15_PAIRS
    from perception_tpu_torch.ops.paf import assemble_people

    rng = np.random.default_rng(5)
    P, K, E, L = 15, 4, 4, len(MPI_15_PAIRS)
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, K, (3, L, E)).astype(np.int32), rng.integers(0, K, (3, L, E)).astype(np.int32),
        rng.random((3, L, E), dtype=np.float32), rng.random((3, L, E)) > 0.3,
        rng.random((3, P, K, 2), dtype=np.float32) * 100, rng.random((3, P, K), dtype=np.float32),
        rng.random((3, P, K)) > 0.2)]
    pairs = torch.from_numpy(MPI_15_PAIRS)
    c = assemble_people(pairs, *args, num_parts=P, max_peaks=K, max_people=6)
    g = assemble_people(pairs.to(cuda_device), *(a.to(cuda_device) for a in args), num_parts=P, max_peaks=K,
                        max_people=6)
    assert int(c.mask.sum()) > 0
    for a, b in zip(g, c):
        assert torch.allclose(a.cpu().float(), b.float(), rtol=0, atol=1e-6)


def test_cuda_crop_image_matches_cpu(cuda_device):
    from perception_tpu_torch.models.hand import crop_image

    img = torch.from_numpy((np.random.default_rng(2).random((96, 96), dtype=np.float32) * 255).astype(np.float32))
    boxes = torch.tensor([[10.3, 5.7, 90.2, 85.6], [30.0, 20.0, 50.0, 40.0], [-10.0, -5.0, 120.0, 110.0]])
    c = crop_image(img, boxes, 64)
    g = crop_image(img.to(cuda_device), boxes.to(cuda_device), 64)
    assert torch.allclose(g.cpu(), c, rtol=0, atol=2e-4)


def test_cuda_tiny_posenet_matches_cpu(cuda_device):
    from perception_tpu_torch.models import pose_fixture as PF

    scenes, images = PF.sample_scenes(np.random.default_rng(7), 4)
    x = torch.from_numpy(images)
    nets = {d: PF.load_fixture(d) for d in ("cpu", cuda_device)}
    with torch.no_grad():
        c = nets["cpu"](x.permute(0, 3, 1, 2).contiguous())
        g = nets[cuda_device](x.to(cuda_device).permute(0, 3, 1, 2).contiguous())
    for a, b in zip(g, c):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-4)
    pc = PF.extract_fixture_people(nets["cpu"], x)
    pg = PF.extract_fixture_people(nets[cuda_device], x.to(cuda_device))
    assert int(pc.mask.sum()) >= 4
    assert torch.equal(pg.mask.cpu(), pc.mask) and torch.equal(pg.num_parts.cpu(), pc.num_parts)
    assert torch.allclose(pg.keypoints.cpu(), pc.keypoints, rtol=0, atol=1e-3)


def test_cuda_face_chain_matches_cpu(cuda_device):
    import chip_smoke
    from perception_tpu_torch.models import face_fixture as FF

    nets = {d: FF.load_fixture(d) for d in ("cpu", cuda_device)}
    for _, img in chip_smoke.face_scenes(n=3):
        c, g = (chip_smoke.face_chain(nets[d], torch.from_numpy(img).to(d), FF.FIXTURE_FX, 64.0, 64.0)
                for d in ("cpu", cuda_device))
        assert torch.equal(g["landmark_mask"].cpu(), c["landmark_mask"]) and bool(g["found"])
        for key, tol in (("box", 1e-3), ("landmarks", 1e-3), ("head_pose", 1e-4), ("au_intensities", 1e-4)):
            assert torch.allclose(g[key].cpu(), c[key], rtol=0, atol=tol), key


def test_cuda_facade_step_matches_cpu(cuda_device):
    import chip_smoke
    from perception_tpu_torch.wrapper import Perception, WrapperStructFace, WrapperStructHand

    frames = chip_smoke.rgb(chip_smoke.three_faces(chip_smoke.FACADE_SEED, n=2)[1])
    face, hand = WrapperStructFace(enabled=True, max_faces=4, detect_every=2), WrapperStructHand(enabled=True,
                                                                                                 top_n_people=2)
    engines = {d: Perception(face=face, hand=hand, device=d) for d in ("cpu", cuda_device)}
    for img in frames:
        c = engines["cpu"].emplace_and_pop(img)
        g = engines[cuda_device].emplace_and_pop(torch.from_numpy(img).to(cuda_device))
        assert torch.equal(g.people.mask.cpu(), c.people.mask)
        assert torch.allclose(g.people.keypoints.cpu(), c.people.keypoints, rtol=0, atol=1e-3)
        assert int(g.faces["mask"].sum()) == 3
        for key in ("mask", "landmark_mask", "ok", "pose_gate"):
            assert torch.equal(g.faces[key].cpu(), c.faces[key]), key
        assert torch.allclose(g.faces["landmarks"].cpu(), c.faces["landmarks"], rtol=0, atol=1e-3)
        assert torch.allclose(g.faces["head_pose"].cpu(), c.faces["head_pose"], rtol=0, atol=1e-4)
        assert torch.equal(g.hands["landmark_mask"].cpu(), c.hands["landmark_mask"])
        assert torch.allclose(g.hands["landmarks"].cpu(), c.hands["landmarks"], rtol=0, atol=1e-2)


def test_cuda_tracker_step_matches_cpu_and_repeats(cuda_device):
    """``person_scene``'s first frames card against CPU; then the slot
    collision (a padding row after a match to the last slot) 20 times on
    the card: the same result every time, the JAX package's on the CPU."""
    import chip_smoke
    from perception_tpu_torch.models.tracking import TrackerConfig, tracker_init, tracker_step

    grays, dets, masks, _ = chip_smoke.person_scene(frames=4)
    cfg = TrackerConfig()
    states = {d: tracker_init(cfg, d) for d in ("cpu", cuda_device)}
    for t in range(4):
        ids = {}
        for d in states:
            g = torch.from_numpy(grays).to(d)
            states[d], ids[d] = tracker_step(states[d], g[max(t - 1, 0)], g[t], torch.from_numpy(dets[t]).to(d),
                                             torch.from_numpy(masks[t]).to(d), cfg)
        assert torch.equal(ids[cuda_device].cpu(), ids["cpu"])
        assert torch.allclose(states[cuda_device].keypoints.cpu(), states["cpu"].keypoints, rtol=0, atol=1e-3)

    cfg = TrackerConfig(max_tracks=2, num_parts=5)
    img = torch.from_numpy(chip_smoke.textured(0, (120, 160))).to(cuda_device)
    person = torch.tensor([[0.0, 8.0 * p, 1.0] for p in range(5)], device=cuda_device)
    at = torch.tensor([[40.0, 30.0, 0.0], [100.0, 40.0, 0.0], [43.0, 30.0, 0.0], [105.0, 40.0, 0.0]],
                      device=cuda_device)
    first = torch.stack([person + at[0], person + at[1]])
    second = torch.cat([torch.stack([person + at[2], person + at[3]]), torch.zeros((1, 5, 3), device=cuda_device)])
    mask = torch.tensor([True, True, False], device=cuda_device)
    st, _ = tracker_step(tracker_init(cfg, cuda_device), img, img, first, mask[:2], cfg)
    results = {tuple(tracker_step(st, img, img, second, mask, cfg)[0].keypoints[:, 0, 0].cpu().tolist())
               for _ in range(20)}
    assert len(results) == 1
    assert np.allclose(next(iter(results)), [43.0, 100.0], atol=1e-2)


TUM_MINI = Path(__file__).parent / "fixtures" / "tum_mini"


def test_cuda_host_native_library_builds(cuda_device):
    from perception_tpu_torch import runtime

    runtime.build_native()
    assert runtime.native_available()


def test_cuda_host_png_decode_without_cv2_matches_numpy_path(cuda_device, tmp_path):
    """The native unfilter against the numpy one on tum_mini and on a
    640x480 depth frame written with each filter type."""
    from perception_tpu_torch.io import png

    files = sorted(TUM_MINI.glob("*/*.png"))
    img = np.random.default_rng(0).integers(0, 65535, (480, 640)).astype(np.uint16)
    for f in range(5):
        png.write_png(tmp_path / f"depth{f}.png", img, filter_type=f)
        files.append(tmp_path / f"depth{f}.png")
    for path in files:
        data = path.read_bytes()
        for color in (False, True):
            a, b = png.decode_png(data, color=color), png.decode_png(data, color=color, native=False)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(png.read_png(tmp_path / "depth4.png"), img)


def test_cuda_host_image_directory_prefetch_matches(cuda_device):
    from perception_tpu_torch.io.producers import ImageDirectoryReader

    got = {p: list(ImageDirectoryReader(TUM_MINI / "rgb", prefetch=p).frames()) for p in (True, False)}
    assert len(got[True]) == len(got[False]) == 30
    for (ta, a), (tb, b) in zip(got[True], got[False]):
        assert ta == tb and a.shape == (120, 160, 3) and np.array_equal(a, b)


def test_cuda_cli_runs_on_the_card_by_default(cuda_device, monkeypatch, capsys):
    """Without --cpu every step of odometry gets its depth on the card."""
    from perception_tpu_torch import cli
    from perception_tpu_torch.models.slam import odometry

    devices = []
    real = odometry.odometry_step

    def step(state, depth, camera, cfg):
        devices.append((state.pose.device.type, depth.device.type))
        return real(state, depth, camera, cfg)

    monkeypatch.setattr(odometry, "odometry_step", step)
    cli.main(["odometry", "--tum", str(TUM_MINI), "--max-frames", "4"])
    assert devices == [("cuda", "cuda")] * 3
    assert '"metric": "ate_rmse_m"' in capsys.readouterr().out


def test_cuda_detect_red_object_matches_cpu(cuda_device):
    from perception_tpu_torch.models.color_detect import detect_red_object, red_mask

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (480, 640, 3), np.uint8)
    img[..., 1] = np.maximum(img[..., 1], img[..., 0])
    img[100:220, 200:380] = np.clip(np.array([200, 20, 20]) + rng.randint(-10, 11, (120, 180, 3)), 0, 255)
    t = torch.from_numpy(img)
    got, want = detect_red_object(t.to(cuda_device)), detect_red_object(t)
    assert [int(v) for v in got] == [int(v) for v in want] == [190, 90, 389, 229, 1]
    assert torch.equal(red_mask(t.to(cuda_device)).cpu(), red_mask(t))


def test_cuda_surface_frame_matches_cpu(cuda_device):
    from chip_smoke import surface_indices, tabletop_cloud
    from perception_tpu_torch.models.cuboid import segment_ground_plane
    from perception_tpu_torch.models.surface_frame import estimate_surface_frame

    pts, _ = tabletop_cloud()
    fit, dpts, box = segment_ground_plane(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool),
                                          torch.Generator().manual_seed(0))
    normal = fit.coefficients[:3]
    idx = surface_indices(dpts, box, normal, torch.Generator().manual_seed(1))
    want = estimate_surface_frame(dpts, box, normal, indices=idx)
    before = ransac_score.launches
    got = estimate_surface_frame(dpts.to(cuda_device), box.to(cuda_device), normal.to(cuda_device),
                                 indices=[i.to(cuda_device) for i in idx])
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 3
    assert torch.equal(got.inlier_counts.cpu(), want.inlier_counts) and bool(got.valid) and bool(want.valid)
    assert float((got.pose.cpu() - want.pose).abs().max()) <= 1e-5


def test_cuda_triangulate_and_fit_match_cpu(cuda_device):
    from chip_smoke import chain_people
    from perception_tpu_torch.models.body_fit import fit_body_from_body25
    from perception_tpu_torch.ops.triangulate import triangulate

    rng = np.random.default_rng(0)
    people = chain_people(rng, 3)
    K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    P = np.stack([K @ np.concatenate([np.eye(3), [[-0.3 * c], [0.0], [0.0]]], 1) for c in range(4)])
    X = people.reshape(-1, 3).astype(np.float64)
    proj = np.einsum("cij,nj->nci", P, np.concatenate([X, np.ones((len(X), 1))], 1))
    uv = (proj[..., :2] / proj[..., 2:] + rng.normal(0, 1.0, proj[..., :2].shape)).astype(np.float32)
    vis = rng.random(uv.shape[:2]) >= 0.05
    args = [torch.from_numpy(a) for a in (P.astype(np.float32), uv, vis)]
    want = triangulate(*args)
    got = triangulate(*(a.to(cuda_device) for a in args))
    assert torch.equal(got.valid.cpu(), want.valid)
    assert float((got.points.cpu() - want.points)[want.valid].abs().max()) <= 1e-4
    kp = want.points.reshape(3, 25, 3)
    conf = want.valid.reshape(3, 25).float() * 0.9
    fw = fit_body_from_body25(kp, conf)
    fg = fit_body_from_body25(kp.to(cuda_device), conf.to(cuda_device))
    assert float((fg.joints.cpu() - fw.joints).abs().max()) <= 1e-3
    assert float((fg.residual.cpu() - fw.residual).abs().max()) <= 1e-4


@pytest.mark.parametrize("n,k", [(32768, 300), (32768, 9), (8192, 2000)])
def test_cuda_segment_sum_is_fixed_order(cuda_device, n, k):
    from perception_tpu_torch.ops.points import segment_sum

    rng = np.random.default_rng(n + k)
    v = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, k, n))
    want = segment_sum(v, ids, k)
    for _ in range(20):
        assert torch.equal(segment_sum(v.to(cuda_device), ids.to(cuda_device), k).cpu(), want)


def test_cuda_full_width_training_step_matches_cpu(cuda_device):
    import chip_smoke
    from perception_tpu_torch.models import train
    from perception_tpu_torch.models.pose import init_posenet
    from perception_tpu_torch.models.pose_data import make_batch

    net = init_posenet(torch.Generator().manual_seed(chip_smoke.TRAIN_SEED), chip_smoke.TRAIN_TOPOLOGY, cuda_device)
    batch = make_batch(np.random.default_rng(chip_smoke.TRAIN_SEED), chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_HW,
                       n_people=chip_smoke.TRAIN_PEOPLE, device=cuda_device)
    trained = chip_smoke.step_against_cpu("full-width step", net, batch, train.pose_loss)
    assert all(p.device.type == "cuda" for p in trained.parameters())


def test_cuda_measure_stage_times_a_matmul(cuda_device):
    from perception_tpu_torch.utils import roofline

    a = torch.randn(512, 256, device=cuda_device)
    b = torch.randn(256, 128, device=cuda_device)
    st = roofline.measure_stage("matmul", torch.matmul, a, b, reps=5, nbytes=4.0 * (512 * 256 + 256 * 128 + 512 * 128))
    assert st.ms > 0.0 and st.flops == 2.0 * 512 * 256 * 128
    assert st.gflops_per_s == pytest.approx(st.flops / (st.ms * 1e-3) / 1e9)
    if roofline.device_peaks(cuda_device) is not None:
        assert st.mfu_f32_pct is not None and st.hbm_pct is not None and st.bound != "unknown"


def test_cuda_render_points_3d_and_depth_to_vis_match_cpu(cuda_device):
    from perception_tpu_torch.bench.scene import render_depth_tabletop
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.viz import depth_to_vis, render_points_3d, render_points_3d_reference

    cam = PinholeCamera.d435_depth()
    depth = render_depth_tabletop(cam, seed=0)
    depth[::9, ::13] = np.nan
    assert torch.equal(depth_to_vis(torch.as_tensor(depth, device=cuda_device), 1.2).cpu(),
                       depth_to_vis(torch.as_tensor(depth), 1.2))
    pts, mask = cam.backproject_depth(torch.as_tensor(np.nan_to_num(depth)))
    cloud = pts[mask][::7].numpy()
    eye = (0.3, -0.4, 0.1)
    card = render_points_3d(torch.as_tensor(cloud, device=cuda_device), eye=eye)
    assert card.device.type == "cuda"
    assert np.array_equal(card.cpu().numpy(), render_points_3d(torch.as_tensor(cloud), eye=eye).numpy())
    assert np.array_equal(card.cpu().numpy(), render_points_3d_reference(cloud, eye=eye))


def test_cuda_example_01_launches_k1_once(cuda_device):
    from examples_torch._common import load
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score

    before = ransac_score.launches
    out = load("01_cuboid_pose_from_depth").main(cuda_device)
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    assert out["accepted"] and np.isfinite(out["pose"]).all()


@pytest.mark.parametrize("moved", [False, True])
def test_cuda_map_shortlist_matches_cpu_from_the_same_state(cuda_device, moved):
    import chip_smoke
    from perception_tpu_torch.bench.slam_bench import bench_camera, bench_config
    from perception_tpu_torch.models.slam.odometry import init_state

    cam = bench_camera()
    depths = [torch.from_numpy(render_textured_room(cam, T, seed=i)[1])
              for i, T in enumerate(sweep_trajectory(n=300)[:2])]
    cfg = bench_config(map_budget=32768, map_nn="auto").odometry
    state = init_state(cam, depths[0], cfg)
    if moved:  # a keyframe away from the origin: the warm start is a product of two poses
        kf = se3.se3_exp(torch.tensor([0.31, -0.12, 0.07, 0.05, -0.21, 0.13]))
        state = state._replace(kf_pose=kf, pose=kf @ se3.se3_exp(torch.tensor([0.01, 0.0, 0.004, 0.0, 0.003, 0.0])))
    want = chip_smoke.first_shortlist(state, depths[1], cam, cfg)
    got = chip_smoke.first_shortlist(chip_smoke.state_to(state, cuda_device), depths[1].to(cuda_device), cam, cfg)
    assert want.shape == (cfg.point_budget, cfg.map_nn_shortlist)
    assert torch.equal(got.cpu(), want)


def test_cuda_paf_limb_sums_are_fixed_order(cuda_device):
    from perception_tpu_torch.models.pose import MPI_15_PAIRS
    from perception_tpu_torch.ops.paf import assemble_people

    rng = np.random.default_rng(9)
    P, K, E, L, B = 15, 16, 16, len(MPI_15_PAIRS), 3
    args = [torch.from_numpy(a) for a in (  # every limb valid: a few roots, each with many limbs
        rng.integers(0, K, (B, L, E)).astype(np.int32), rng.integers(0, K, (B, L, E)).astype(np.int32),
        rng.random((B, L, E), dtype=np.float32), np.ones((B, L, E), bool),
        rng.random((B, P, K, 2), dtype=np.float32) * 100, rng.random((B, P, K), dtype=np.float32),
        np.ones((B, P, K), bool))]
    pairs = torch.from_numpy(MPI_15_PAIRS)
    want = assemble_people(pairs, *args, num_parts=P, max_peaks=K, max_people=6)
    assert int(want.mask.sum()) >= B and int(want.num_parts.max()) > 100
    for _ in range(20):
        got = assemble_people(pairs.to(cuda_device), *(a.to(cuda_device) for a in args), num_parts=P, max_peaks=K,
                              max_people=6)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_cuda_nets_in_float32_under_tf32_callers(cuda_device, monkeypatch):
    """``Perception`` on a 480x640 three-face frame with the BODY_25 net at
    368x368 and ``extract_people`` at 368x368, with both TF32 flags set by
    the caller: the CPU's maps, keypoints and face landmarks, and the
    caller's flags after."""
    import copy
    import dataclasses

    import chip_smoke
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.pose import extract_people
    from perception_tpu_torch.wrapper import Perception, WrapperStructFace, WrapperStructHand, WrapperStructPose

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fx = FF.FIXTURE_FX * max(chip_smoke.FULL_HW) / max(FF.FIXTURE_HW)
    frame = chip_smoke.rgb(chip_smoke.three_faces(chip_smoke.FACADE_SEED, chip_smoke.FULL_HW, fx,
                                                  chip_smoke.FULL_OFFSETS, chip_smoke.FULL_Z, n=1)[1])[0]
    pose = WrapperStructPose(topology="BODY_25", net_hw=chip_smoke.WIDE_HW)
    face, hand = WrapperStructFace(enabled=True, max_faces=4), WrapperStructHand(enabled=True, top_n_people=2)
    card = Perception(pose=pose, face=face, hand=hand, device=cuda_device)
    net_cpu = copy.deepcopy(card._pose_net).cpu()
    host = Perception(pose=dataclasses.replace(pose, params=net_cpu), face=face, hand=hand, device="cpu")
    with chip_smoke.face_landmark_maps() as maps:
        got = card.emplace_and_pop(torch.from_numpy(frame).to(cuda_device))
        want = host.emplace_and_pop(frame)
    assert int(want.faces["mask"].sum()) == 3
    chip_smoke.compare_datum("facade under TF32 callers", got, want, maps=maps)

    x = torch.from_numpy(np.random.default_rng(1).random(chip_smoke.WIDE_HW + (3,), dtype=np.float32))
    for a, b in zip(card._pose_net(x.to(cuda_device).permute(2, 0, 1)[None]), net_cpu(x.permute(2, 0, 1)[None])):
        assert float((a.cpu() - b).abs().max()) <= chip_smoke.WIDE_MAP_RTOL * max(float(b.abs().max()), 1.0)
    chip_smoke.compare_people("extract_people under TF32 callers",
                              extract_people(card._pose_net, x.to(cuda_device), "BODY_25", net_hw=chip_smoke.WIDE_HW),
                              extract_people(net_cpu, x, "BODY_25", net_hw=chip_smoke.WIDE_HW))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
