"""Voxel-hash range query: the CUDA kernel and its plain version.

Counterpart of ``perception_tpu/ops/voxelhash.py``'s two Pallas query
kernels (``_query_kernel_pallas``, table in VMEM, and
``_query_kernel_pallas_stream``, table streamed from HBM above 49152
rows): one kernel, ``csrc/voxelhash_query.cu``, serves every table size.

Queries come in tiles of ``tile`` rows. Tile i scans the rows
``[start[i], start[i] + nchunk[i] * rblk)`` of the cell-sorted table and
returns, per query, the first index of the minimum of ``(q - p)^2`` and
that minimum, starting from ``(0, 4e12)`` as the Pallas kernels do. The
plain version mirrors ``_query_kernel_xla``: a static ``R``-row window per
tile with the rows past the tile's chunks at 4e12.

``voxelhash_query`` launches the kernel for CUDA tensors and takes
``voxelhash_query_reference`` only for CPU tensors. Both compute
``(dx*dx + dy*dy) + dz*dz`` with every operation rounded on its own, so
they are bit-identical. The kernel spreads each tile's window over
blocks of ``piece_rows`` rows; ``launch_plan`` fixes the pieces from the
shapes and the card's SM count alone, never from device data.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from perception_tpu_torch.ops.kernels.build import load_library, sm_count

FAR = 4.0e12  # > (2 * SENTINEL)^2: "no candidate yet"
_MAX_RBLK = 512  # the kernel's shared-memory stage
_MIN_PIECE = 128  # 32 rows for each of the kernel's four threads a query
# Scan blocks the plan aims for on each SM. A block whose piece lies past
# its tile's range returns at once; at the SLAM map's shape about a third
# of them are live (164 of 528 at 512-row pieces, PERF.md), so six
# launched a SM aim at two live.
BLOCKS_PER_SM = 6
# Bounds the plain version's (tiles, tile, R) distance temporaries.
_REF_ELEMS = 1 << 22


def voxelhash_query_reference(table, queries, start, nchunk, tile: int, R: int, rblk: int):
    """Plain PyTorch version: (Npad, 8) table, (Nqp, 3) queries, (ntiles,)
    row starts and chunk counts -> (idx (Nqp,) int32, d2 (Nqp,) f32)."""
    npad = table.shape[0]
    ntiles = queries.shape[0] // tile
    rows = torch.arange(R, device=table.device)
    group = max(1, _REF_ELEMS // (tile * R))
    idx_out, d2_out = [], []
    for g in range(0, ntiles, group):
        s0 = start[g:g + group].to(torch.int64)
        win = s0[:, None] + rows                                        # (G, R)
        covered = (rows < nchunk[g:g + group, None] * rblk) & (win < npad)
        p = table[torch.clamp(win, max=npad - 1)]                       # (G, R, 8)
        q = queries[g * tile:(g + len(s0)) * tile].reshape(len(s0), tile, 1, 3)
        dx = q[..., 0] - p[:, None, :, 0]
        dy = q[..., 1] - p[:, None, :, 1]
        dz = q[..., 2] - p[:, None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz                              # (G, tile, R)
        d2 = torch.where(covered[:, None, :], d2, torch.full_like(d2, FAR))
        best, loc = torch.min(d2, dim=-1)  # first index of the minimum
        # The kernels' start (0, FAR) where no candidate is nearer than FAR
        # (2e6 m); _query_kernel_xla's argmin differs only there.
        take = best < FAR
        idx_out.append(torch.where(take, s0[:, None] + loc, 0).reshape(-1))
        d2_out.append(torch.where(take, best, FAR).reshape(-1))
    return torch.cat(idx_out).to(torch.int32), torch.cat(d2_out)


class LaunchPlan(NamedTuple):
    """The scan's grid: ``tiles`` x ``pieces`` blocks; piece p of a tile
    covers rows ``[p * piece_rows, (p + 1) * piece_rows)`` of its window."""
    tiles: int
    pieces: int
    piece_rows: int
    blocks: int


def launch_plan(nqp: int, tile: int, R: int, rblk: int, sms: int) -> LaunchPlan:
    """Cut each tile's R-row window into pieces of ``rblk`` rows, halved
    while the grid has fewer than ``BLOCKS_PER_SM * sms`` blocks (not
    below ``_MIN_PIECE`` rows); pieces ascend and cover ``[0, R)`` once.
    With 132 SMs: 256-row pieces at 16 tiles (2048 queries), 512 at 32."""
    tiles = nqp // tile
    piece = rblk
    while (tiles * -(-R // piece) < BLOCKS_PER_SM * sms and piece % 2 == 0
           and piece // 2 >= _MIN_PIECE):
        piece //= 2
    pieces = -(-R // piece)
    return LaunchPlan(tiles, pieces, piece, tiles * pieces)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("voxelhash_query").voxelhash_query_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def _check(table, queries, start, nchunk, tile, R, rblk):
    if table.dim() != 2 or table.shape[1] != 8:
        raise ValueError(f"table must be (Npad, 8), got {tuple(table.shape)}")
    if queries.dim() != 2 or queries.shape[1] != 3 or queries.shape[0] % tile:
        raise ValueError(f"queries must be (a multiple of {tile}, 3), got {tuple(queries.shape)}")
    ntiles = queries.shape[0] // tile
    if not 0 < tile <= 1024 or not 0 < rblk <= _MAX_RBLK:
        raise ValueError(f"tile must lie in (0, 1024] and rblk in (0, {_MAX_RBLK}]")
    if R <= 0:
        raise ValueError(f"R must be positive, got {R}")
    for name, t, dt in (("table", table, torch.float32), ("queries", queries, torch.float32),
                        ("start", start, torch.int32), ("nchunk", nchunk, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if start.shape != (ntiles,) or nchunk.shape != (ntiles,):
        raise ValueError(f"start and nchunk must be ({ntiles},)")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (the kernel reads float4 rows)")


def voxelhash_query(table, queries, start, nchunk, tile: int, R: int, rblk: int = 512):
    """Per-tile range nearest neighbour: (idx (Nqp,) int32, d2 (Nqp,) f32).

    ``R`` caps the window (the caller's ``nchunk`` never exceeds
    ``R // rblk``; the kernel, like the plain version, scans at most R
    rows a tile). CPU tensors take the plain version; CUDA tensors
    launch the kernel (``voxelhash_query.launches`` counts them) or raise."""
    if queries.device.type == "cpu":
        return voxelhash_query_reference(table, queries, start, nchunk, tile, R, rblk)
    if queries.device.type != "cuda":
        raise ValueError(f"voxelhash_query runs on CPU or CUDA tensors, not {queries.device}")
    _check(table, queries, start, nchunk, tile, R, rblk)
    nqp = queries.shape[0]
    idx = torch.empty(nqp, dtype=torch.int32, device=queries.device)
    d2 = torch.empty(nqp, dtype=torch.float32, device=queries.device)
    if nqp == 0:
        return idx, d2
    launch = _launcher()
    plan = launch_plan(nqp, tile, R, rblk, sm_count(queries.device.index))
    part = torch.empty((plan.tiles, plan.pieces, tile, 2), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = launch(queries.data_ptr(), table.data_ptr(), start.data_ptr(), nchunk.data_ptr(),
                     nqp, table.shape[0], tile, rblk, R, plan.piece_rows, plan.pieces,
                     part.data_ptr(), idx.data_ptr(), d2.data_ptr(), stream)
    if err:
        raise RuntimeError(f"voxelhash_query kernel launch failed: CUDA error {err}")
    voxelhash_query.launches += 1
    return idx, d2


voxelhash_query.launches = 0
