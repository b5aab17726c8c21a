"""The launch plans of the port's K1 (``ops/kernels/ransac_score.launch_plan``),
K2 (``ops/kernels/icp_gn.launch_plan``) and K3+K4
(``ops/kernels/voxelhash_query.launch_plan``) kernels, on the CPU with an
H100's 132 SMs passed in.

K1's plan splits each frame's points over blocks of 128 hypotheses: the
tests check that its blocks score every (point, hypothesis) pair exactly
once at the four path shapes (B=1 and 8 at N=8192, N=32768, N=24576, all
at K=1024) and at (3, 777, 100) and (1, 8192, 1023), and that each path
shape puts at least 8 warps on each SM.

Each plan splits a scan over blocks: K2 the target axis, K3+K4 each query
tile's window of table rows. The tests check that every target row or
window row is covered exactly once by splits or pieces that ascend, that
the grid has at least two blocks per SM at the paths' shapes (odometry's
4096 x 8192, the SLAM bench's 2048 x 4096, the SLAM map hash at 2048
queries on 32768 points). The kernels' merge of splits and pieces is
tested on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from perception_tpu_torch.ops import voxelhash
from perception_tpu_torch.ops.kernels import icp_gn
from perception_tpu_torch.ops.kernels import ransac_score as k1
from perception_tpu_torch.ops.kernels import voxelhash_query as vq

SMS = 132  # an H100 SXM

torch.set_num_threads(2)


K1_PATH_SHAPES = [(1, 8192, 1024), (8, 8192, 1024), (1, 32768, 1024), (1, 24576, 1024)]


def k1_tiles(plan, B, N, K):
    """(frame, points, hypotheses) of each block of K1's grid (hypothesis
    block, split, frame), as csrc/ransac_score.cu indexes them."""
    for b in range(B):
        for s in range(plan.splits):
            pts = range(s * plan.split_chunks * k1.CHUNK, min((s + 1) * plan.split_chunks * k1.CHUNK, N))
            for h in range(plan.hyp_blocks):
                yield b, pts, range(h * k1.HYPS_PER_BLOCK, min((h + 1) * k1.HYPS_PER_BLOCK, K))


@pytest.mark.parametrize("B,N,K", K1_PATH_SHAPES + [(3, 777, 100), (1, 8192, 1023)])
def test_k1_plan_scores_every_pair_once(B, N, K):
    plan = k1.launch_plan(B, N, K, SMS)
    seen = np.zeros((B, N, K), np.int32)
    tiles = list(k1_tiles(plan, B, N, K))
    assert len(tiles) == plan.blocks == plan.hyp_blocks * plan.splits * B
    for b, pts, hyps in tiles:
        assert len(pts) > 0 and len(hyps) > 0  # no empty block
        assert len(pts) <= plan.split_chunks * k1.CHUNK and len(hyps) <= k1.HYPS_PER_BLOCK
        seen[b, pts.start:pts.stop, hyps.start:hyps.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,N,K", K1_PATH_SHAPES)
def test_k1_plan_fills_the_card_at_the_path_shapes(B, N, K):
    plan = k1.launch_plan(B, N, K, SMS)
    assert plan.warps_per_sm == plan.blocks * k1.WARPS / SMS >= 8
    # All resident at once: the kernel's launch bounds allow 4 blocks an SM.
    assert plan.blocks <= 4 * SMS


def test_k1_plan_takes_one_split_on_a_one_sm_card():
    plan = k1.launch_plan(1, 8192, 1024, 1)
    assert plan.splits == 1 and plan.split_chunks == 8192 // k1.CHUNK
    # A split never holds more points than a lane's float32 count keeps exact.
    plan = k1.launch_plan(1, 1 << 25, 1024, 1)
    assert plan.split_chunks * k1.CHUNK == 1 << 24 and plan.splits == 2


def k2_ranges(plan, Mp):
    return [(s * plan.split_rows, min((s + 1) * plan.split_rows, Mp)) for s in range(plan.splits)]


def padded(N, M):
    """(Np, Mp) as pack_source and pack_target pad them."""
    return -(-N // 512) * 512, -(-M // 1024) * 1024


@pytest.mark.parametrize("R,N,M", [
    (1, 4096, 8192),     # the default OdometryConfig
    (1, 2048, 4096),     # the SLAM bench's keyframe mode
    (1, 8192, 32768),
    (4, 1024, 1280),     # the cuboid ICP's restarts
    (3, 217, 100),       # unaligned, padded as the packers pad
])
@pytest.mark.parametrize("pad", [True, False])
def test_k2_plan_covers_every_target_row_once(R, N, M, pad):
    Np, Mp = padded(N, M) if pad else (N, M)
    plan = icp_gn.launch_plan(R, Np, Mp, SMS)
    assert plan.split_rows % icp_gn.NN_CHUNK == 0 and plan.split_rows > 0
    ranges = k2_ranges(plan, Mp)
    assert all(lo < hi for lo, hi in ranges)  # no empty split
    assert [lo for lo, _ in ranges] == sorted(lo for lo, _ in ranges)
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    assert np.array_equal(rows, np.arange(Mp))
    assert plan.src_tiles * icp_gn.NN_SRC_TILE >= Np > (plan.src_tiles - 1) * icp_gn.NN_SRC_TILE
    assert plan.blocks == plan.src_tiles * plan.splits * R


@pytest.mark.parametrize("N,M", [(4096, 8192), (2048, 4096), (8192, 32768)])
def test_k2_plan_fills_the_card_at_the_path_shapes(N, M):
    plan = icp_gn.launch_plan(1, *padded(N, M), SMS)
    assert plan.blocks >= 2 * SMS


def test_k2_plan_depends_on_the_sm_count_only_through_the_split():
    small, large = (icp_gn.launch_plan(1, 4096, 8192, sms) for sms in (16, 132))
    assert small.src_tiles == large.src_tiles and small.splits < large.splits


def query_args(m, nq, order="sorted", seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    q = torch.from_numpy(ref[rng.randint(0, m, nq)] + (rng.randn(nq, 3) * 0.01).astype(np.float32))
    vh = voxelhash.build(torch.from_numpy(ref), torch.ones(m, dtype=torch.bool), 0.06)
    if order == "sorted":
        q, _ = voxelhash.sort_by_cell(vh, q)
    args, _ = voxelhash.kernel_args(vh, q)
    return args


def k3_pieces(plan, R):
    return [(p * plan.piece_rows, min((p + 1) * plan.piece_rows, R)) for p in range(plan.pieces)]


@pytest.mark.parametrize("m,nq,order", [
    (32768, 2048, "sorted"),    # the SLAM map hash (33792 rows, below 49152)
    (65536, 4096, "sorted"),    # above 49152 rows
    (32768, 1000, "caller"),    # unaligned query count, incoherent order
    (4000, 300, "sorted"),      # a small map: the pieces are halved
])
def test_k3_plan_covers_every_window_row_once(m, nq, order):
    table, queries, start, nchunk, tile, R, rblk = query_args(m, nq, order)
    plan = vq.launch_plan(queries.shape[0], tile, R, rblk, SMS)
    assert plan.tiles * tile == queries.shape[0] and plan.blocks == plan.tiles * plan.pieces
    assert rblk % plan.piece_rows == 0 and 128 <= plan.piece_rows <= 512
    pieces = k3_pieces(plan, R)
    assert all(lo < hi for lo, hi in pieces)
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in pieces])
    assert np.array_equal(rows, np.arange(R))
    # The caller's chunk counts never pass the window, so no live piece is cut.
    assert int(nchunk.max()) * rblk <= R


@pytest.mark.parametrize("m,nq,piece_rows", [
    (32768, 2048, 256),   # the SLAM map hash: 16 tiles, pieces halved
    (65536, 4096, 512),   # 32 tiles fill the card at R / rblk pieces
])
def test_k3_plan_fills_the_card_at_the_hash_shapes(m, nq, piece_rows):
    _, queries, _, _, tile, R, rblk = query_args(m, nq)
    plan = vq.launch_plan(queries.shape[0], tile, R, rblk, SMS)
    assert (tile, R, rblk) == (128, 16896, 512)
    assert plan.piece_rows == piece_rows and plan.pieces == R // piece_rows
    assert plan.blocks >= vq.BLOCKS_PER_SM * SMS >= 2 * SMS
