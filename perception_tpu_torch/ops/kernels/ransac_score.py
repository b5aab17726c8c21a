"""Fused RANSAC hypothesis scoring: the CUDA kernel and its plain version.

Counterpart of ``perception_tpu/ops/pallas/ransac_score.py``. Scores K
plane hypotheses against the N points of each of B frames:

    score[b, k] = sum_i mask[b, i] * (|((x*a + y*b) + z*c) + d| <= tau)

``ransac_score`` launches ``csrc/ransac_score.cu`` for CUDA tensors and
takes ``ransac_score_reference`` only for CPU tensors. Both round every
multiply and add separately, in the same order, so their counts are
bit-identical. ``launch_plan`` splits the points over blocks from the
shapes and the SM count alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from perception_tpu_torch.ops.kernels.build import load_library, sm_count
from perception_tpu_torch.utils.profiler import count_launch, counts_launches

# Bounds the plain version's (B, chunk, K) temporaries; integer sums
# make the chunking invisible in the result.
_REF_CHUNK = 2048

# The kernel's compile-time tiling (csrc/ransac_score.cu); the launch
# passes them, and the kernel refuses a plan made for another build.
CHUNK = 256            # points staged per chunk, one per thread
HYPS_PER_BLOCK = 128   # 4 a lane, shared by the block's warps
WARPS = 8              # warps per block
BLOCKS_PER_SM = 4      # blocks the plan aims for on each SM
MAX_SPLIT_CHUNKS = (1 << 24) // CHUNK  # a lane's float32 counts are exact to 2^24


class LaunchPlan(NamedTuple):
    hyp_blocks: int    # blocks along K, HYPS_PER_BLOCK hypotheses each
    splits: int        # blocks along N per frame
    split_chunks: int  # CHUNK-point chunks per split (the last split may hold fewer)
    blocks: int        # hyp_blocks * splits * B
    warps_per_sm: float


def launch_plan(B: int, N: int, K: int, sms: int) -> LaunchPlan:
    """Split each frame's points into ``splits`` runs of ``split_chunks``
    chunks so that the grid has about ``BLOCKS_PER_SM * sms`` blocks, or
    one block per chunk where the frames hold fewer; no split is empty."""
    hyp_blocks = -(-K // HYPS_PER_BLOCK)
    chunks = max(1, -(-N // CHUNK))
    want = -(-BLOCKS_PER_SM * sms // max(hyp_blocks * B, 1))
    split_chunks = min(-(-chunks // want), MAX_SPLIT_CHUNKS)
    splits = -(-chunks // split_chunks)
    blocks = hyp_blocks * splits * B
    return LaunchPlan(hyp_blocks, splits, split_chunks, blocks, blocks * WARPS / sms)


def ransac_score_reference(
    points: torch.Tensor, mask: torch.Tensor, hyp: torch.Tensor, threshold: float
) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3), (B, N), (B, K, 4) -> (B, K) int32."""
    a, b, c, d = (hyp[..., None, :, j] for j in range(4))  # (B, 1, K)
    score = torch.zeros(hyp.shape[:-1], dtype=torch.int32, device=hyp.device)
    for s in range(0, points.shape[-2], _REF_CHUNK):
        p = points[..., s:s + _REF_CHUNK, :]
        dist = p[..., 0:1] * a + p[..., 1:2] * b + p[..., 2:3] * c + d  # (B, n, K)
        inl = (dist.abs() <= threshold) & mask[..., s:s + _REF_CHUNK, None]
        score += inl.sum(dim=-2, dtype=torch.int32)
    return score


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("ransac_score").ransac_score_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(points, mask, hyp):
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    B, N, _ = points.shape
    if mask.shape != (B, N):
        raise ValueError(f"mask must be {(B, N)}, got {tuple(mask.shape)}")
    if hyp.dim() != 3 or hyp.shape[0] != B or hyp.shape[-1] != 4:
        raise ValueError(f"hyp must be ({B}, K, 4), got {tuple(hyp.shape)}")
    for name, t, dt in (("points", points, torch.float32), ("mask", mask, torch.bool),
                        ("hyp", hyp, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on {points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hyp.data_ptr() % 16:
        raise ValueError("hyp must be 16-byte aligned (the kernel reads float4 rows)")


@counts_launches
def ransac_score(
    points: torch.Tensor, mask: torch.Tensor, hyp: torch.Tensor, threshold: float
) -> torch.Tensor:
    """Inlier count per hypothesis: (B, N, 3) f32, (B, N) bool, (B, K, 4)
    f32 = [normal | d] -> (B, K) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``ransac_score.launches`` counts those launches, and
    ``ransac_score.launches_by_shape`` counts them by (B, N, K)) or raise."""
    if points.device.type == "cpu":
        return ransac_score_reference(points, mask, hyp, threshold)
    if points.device.type != "cuda":
        raise ValueError(f"ransac_score runs on CPU or CUDA tensors, not {points.device}")
    _check(points, mask, hyp)
    B, N, _ = points.shape
    K = hyp.shape[1]
    out = torch.zeros((B, K), dtype=torch.int32, device=points.device)
    if B == 0 or N == 0 or K == 0:
        return out
    launch = _launcher()
    plan = launch_plan(B, N, K, sm_count(points.device.index))
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = launch(points.data_ptr(), mask.data_ptr(), hyp.data_ptr(), B, N, K, threshold,
                     CHUNK, HYPS_PER_BLOCK, plan.split_chunks, plan.splits, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"ransac_score kernel launch failed: CUDA error {err}")
    count_launch(ransac_score, (B, N, K))
    return out
