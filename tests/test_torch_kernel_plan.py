"""The launch plans of the port's K2 (``ops/kernels/icp_gn.launch_plan``)
and K3+K4 (``ops/kernels/voxelhash_query.launch_plan``) kernels, on the
CPU with an H100's 132 SMs passed in.

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
from perception_tpu_torch.ops.kernels import voxelhash_query as vq

SMS = 132  # an H100 SXM

torch.set_num_threads(2)


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
