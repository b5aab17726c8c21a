"""The port on a CUDA card: its kernels against their plain versions, and
the cuboid pipeline and SLAM odometry against the port's CPU path. Every
test skips without a card.

This file imports neither jax nor the JAX package, so it also runs where
the card is, which has no JAX; the tests' conftest imports jax, so run it
there with ``--noconftest`` (see README.md).

Tolerances: the kernel's counts equal the plain version's exactly (both
round each multiply and add separately), at K1's four path shapes and at
K=1023, B=3 and N=777, on random points and on ``chip_smoke``'s edge
inputs (points exactly at +-tau, one ulp past, -0.0, NaN and +-inf, valid
and masked), one launch a call; every (point, hypothesis) pair of a launch
plan is scored once, whatever the plan's splits. Pipeline on the card against
the CPU with the same RANSAC triplets: same acceptance, translation
within 1 mm, fitness within rtol 5e-2 — CUDA's ``index_add_`` adds with
atomics, so a voxel centroid may move by an ulp and one point may cross
the RANSAC threshold. The fused GN system (K2): equal gate counts, M and
the gated d2 sum within rtol/atol 1e-4 (float sums in another order). The
voxel-hash query (K3+K4): bit-identical (both round each operation).
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
The pose and hand path, with TF32 off for cuDNN and cuBLAS: ``nms_heatmap``
on random maps and on a plateau with tied peaks equal to the CPU's
(positions within 1e-6); ``assemble_people`` equal; ``crop_image`` of a
[0, 255] image (a box larger than the crop, one partly outside) within
2e-4; the tiny trained PoseNet's maps within 1e-4 and its
``extract_people`` on 4 fixture scenes: the same people, keypoints within
1e-3 px.
"""

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


K1_SHAPES = [(1, 8192, 1024), (8, 8192, 1024), (1, 32768, 1024), (1, 24576, 1024),
             (3, 777, 100), (1, 8192, 1023), (2, 777, 100), (3, 1, 1)]


@pytest.mark.parametrize("b,n,k", K1_SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, k):
    pts, mask, hyp = (torch.from_numpy(a).to(cuda_device) for a in random_case(b, b, n, k))
    before = ransac_score.launches
    got = ransac_score(pts, mask, hyp, 0.05)
    torch.cuda.synchronize()
    assert ransac_score.launches == before + 1
    assert torch.equal(got, ransac_score_reference(pts, mask, hyp, 0.05))


@pytest.mark.parametrize("b,n,k", K1_SHAPES[:6])
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
