"""Fused Gauss-Newton ICP system: the CUDA kernel and its plain version.

Counterpart of ``perception_tpu/ops/pallas/icp_gn.py``. For each restart
r, with the source transformed by the pose ``Ts[r]``, nearest neighbours
by ``d2 = |p|^2 - 2 (p.t - |t|^2 / 2)`` over the whole target, and the
gated, Huber-weighted point-to-plane residual ``r = n.(p - q)``:

    M[r] = sum_i w_i Jhat_i^T Jhat_i,   Jhat = [n, p x n, r, 1]   (8, 8)
    stats[r] = [sum_i gate_i, sum_i gate_i * max(d2_i, 0)]

so ``M[:6, :6]`` is the normal matrix, ``M[:6, 6]`` the gradient and
``M[7, 7]`` the total weight. Operands are packed once per solve
(``pack_source``, ``pack_target``); each iteration passes only the pose,
which the kernel reads on the device, so a Gauss-Newton loop never
reads a pose back to the host.

``gn_system_packed`` launches ``csrc/icp_gn.cu`` for CUDA tensors and
takes ``gn_system_reference`` only for CPU tensors. Both round the
transform and distance arithmetic operation by operation in the same
order, so they find the same neighbours; M and the stats differ by the
order of their float sums. The kernel's nearest-neighbour phase splits
the target axis over blocks; ``launch_plan`` fixes the split from the
shapes and the card's SM count alone, never from device data.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops import nn as _nn
from perception_tpu_torch.ops.icp import _huber_weight
from perception_tpu_torch.ops.kernels.build import load_library, sm_count
from perception_tpu_torch.ops.points import SENTINEL

# Bounds the plain version's (R, N, chunk) distance temporaries; the
# running strict '<' makes the chunking invisible in the result.
_REF_ELEMS = 1 << 22

# The kernel's geometry (csrc/icp_gn.cu; checked against the library at load).
SYSTEM_THREADS = 256  # system phase: source points per block
NN_SRC_TILE = 256     # NN phase: source points per block (64 threads x 4 points)
NN_CHUNK = 64         # NN phase: target rows per shared-memory stage
BLOCKS_PER_SM = 16    # NN blocks the plan aims for on each SM (PERF.md, PR 4 findings)


class LaunchPlan(NamedTuple):
    """The NN phase's grid: ``src_tiles`` x ``splits`` x R blocks; split s
    scans target rows ``[s * split_rows, min((s + 1) * split_rows, Mp))``."""
    src_tiles: int
    splits: int
    split_rows: int
    blocks: int


def launch_plan(R: int, Np: int, Mp: int, sms: int) -> LaunchPlan:
    """Split the target axis so that the NN phase launches about
    ``BLOCKS_PER_SM * sms`` blocks, each split a whole number of stage
    chunks, the splits ascending and covering ``[0, Mp)`` once."""
    src_tiles = -(-Np // NN_SRC_TILE)
    chunks = -(-Mp // NN_CHUNK)
    want = -(-BLOCKS_PER_SM * sms // max(src_tiles * R, 1))
    per_split = max(1, chunks // want)
    splits = -(-chunks // per_split)
    return LaunchPlan(src_tiles, splits, per_split * NN_CHUNK, src_tiles * splits * R)


def pack_source(src: torch.Tensor, src_mask: torch.Tensor, block: int = 512) -> torch.Tensor:
    """(R, N, 3) points + (R, N) mask -> (R, Np, 8) rows
    [x, y, z, -0.5, valid, 0, 0, 0], Np a multiple of ``block``."""
    R, N, _ = src.shape
    n_pad = (-N) % block
    src8 = torch.cat(
        [src, torch.full((R, N, 1), -0.5, dtype=src.dtype, device=src.device),
         src_mask[..., None].to(src.dtype), src.new_zeros((R, N, 3))],
        dim=-1,
    )
    return torch.cat([src8, src8.new_zeros((R, n_pad, 8))], dim=1)


def pack_target(target: torch.Tensor, target_normals: torch.Tensor,
                target_mask: torch.Tensor, tchunk: int = 1024):
    """(M, 3) target + normals + mask -> (tgtd, tn), each (Mp, 8) with Mp
    a multiple of ``tchunk``: tgtd = [x, y, z, |t|^2, 0...], tn = [x, y,
    z, nx, ny, nz, 0, 0]; masked and padded rows parked at 1e6."""
    M = target.shape[0]
    m_pad = (-M) % tchunk
    tgt = torch.where(target_mask[:, None], target, const(SENTINEL, target))
    tgt_p = torch.cat([tgt, torch.full((m_pad, 3), SENTINEL, dtype=tgt.dtype, device=tgt.device)])
    t_sq = torch.sum(tgt_p * tgt_p, dim=1, keepdim=True)
    tgtd = torch.cat([tgt_p, t_sq, tgt_p.new_zeros((M + m_pad, 4))], dim=1)
    nrm_p = torch.cat([target_normals, target_normals.new_zeros((m_pad, 3))])
    tn = torch.cat([tgt_p, nrm_p, tgt_p.new_zeros((M + m_pad, 2))], dim=1)
    return tgtd, tn


def _scalars(Ts: torch.Tensor, max_correspondence_distance: float, huber_delta: float):
    """(R, 16) rows [max_d2, huber, R (9, row-major), t (3), 0, 0] on Ts's device."""
    R = Ts.shape[0]
    head = const([max_correspondence_distance**2, huber_delta], Ts).expand(R, 2)
    return torch.cat(
        [head, Ts[:, :3, :3].reshape(R, 9), Ts[:, :3, 3], Ts.new_zeros((R, 2))], dim=1
    ).contiguous()


def gn_system_reference(src8, tgtd, tn, Ts, max_correspondence_distance, huber_delta):
    """Plain PyTorch version: returns (M (R, 8, 8), stats (R, 2))."""
    sc = _scalars(Ts, max_correspondence_distance, huber_delta)
    c = [sc[:, k, None] for k in range(16)]  # each (R, 1)
    x0, y0, z0, valid = src8[..., 0], src8[..., 1], src8[..., 2], src8[..., 4]
    x = ((c[2] * x0 + c[3] * y0) + c[4] * z0) + c[11]
    y = ((c[5] * x0 + c[6] * y0) + c[7] * z0) + c[12]
    z = ((c[8] * x0 + c[9] * y0) + c[10] * z0) + c[13]
    p_sq = (x * x + y * y) + z * z

    R, Np = x.shape
    Mp = tgtd.shape[0]
    step = max(1, _REF_ELEMS // max(R * Np, 1))
    dmin = torch.full_like(x, float("inf"))
    best = torch.zeros((R, Np), dtype=torch.int64, device=x.device)
    xe, ye, ze, pe = x[..., None], y[..., None], z[..., None], p_sq[..., None]
    for s in range(0, Mp, step):
        t = tgtd[s:s + step]
        half = ((xe * t[:, 0] + ye * t[:, 1]) + ze * t[:, 2]) + (-0.5 * t[:, 3])
        d2 = pe - 2.0 * half
        cmin, carg = torch.min(d2, dim=-1)  # first index of the minimum
        take = cmin < dmin
        dmin = torch.where(take, cmin, dmin)
        best = torch.where(take, carg + s, best)

    q = tn[best]  # (R, Np, 8)
    n0, n1, n2 = q[..., 3], q[..., 4], q[..., 5]
    gate = ((dmin <= c[0]) & (valid > 0.5)).to(x.dtype)
    r = (n0 * (x - q[..., 0]) + n1 * (y - q[..., 1])) + n2 * (z - q[..., 2])
    absr = torch.abs(r)
    hub = c[1]
    w = gate * torch.where(absr <= hub, torch.ones_like(r), hub / torch.clamp(absr, min=1e-12))
    jhat = torch.stack(
        [n0, n1, n2, y * n2 - z * n1, z * n0 - x * n2, x * n1 - y * n0, r, torch.ones_like(r)],
        dim=-1,
    )
    jw = jhat * w[..., None]
    M = torch.sum(jw[..., :, None] * jhat[..., None, :], dim=-3)
    stats = torch.stack(
        [gate.sum(dim=-1), (torch.clamp(dmin, min=0.0) * gate).sum(dim=-1)], dim=-1
    )
    return M, stats


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = load_library("icp_gn")
    geometry = (ctypes.c_int * 3)()
    lib.icp_gn_geometry(geometry)
    if tuple(geometry) != (SYSTEM_THREADS, NN_SRC_TILE, NN_CHUNK):
        raise RuntimeError(f"csrc/icp_gn.cu's geometry {tuple(geometry)} differs from the wrapper's")
    fn = lib.icp_gn_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _check(src8, tgtd, tn, Ts):
    if src8.dim() != 3 or src8.shape[-1] != 8:
        raise ValueError(f"src8 must be (R, Np, 8), got {tuple(src8.shape)}")
    R = src8.shape[0]
    for name, t in (("tgtd", tgtd), ("tn", tn)):
        if t.dim() != 2 or t.shape[-1] != 8 or t.shape[0] != tgtd.shape[0]:
            raise ValueError(f"{name} must be (Mp, 8) like tgtd, got {tuple(t.shape)}")
    if Ts.shape != (R, 4, 4):
        raise ValueError(f"Ts must be ({R}, 4, 4), got {tuple(Ts.shape)}")
    for name, t in (("src8", src8), ("tgtd", tgtd), ("tn", tn), ("Ts", Ts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != src8.device:
            raise ValueError(f"{name} is on {t.device}, src8 on {src8.device}")
        if name != "Ts" and not t.is_contiguous():  # the wrapper makes Ts contiguous
            raise ValueError(f"{name} must be contiguous")
    if tgtd.data_ptr() % 16:
        raise ValueError("tgtd must be 16-byte aligned (the kernel reads float4 rows)")


def gn_system_packed(src8, tgtd, tn, Ts, max_correspondence_distance: float,
                     huber_delta: float, return_stats: bool = False):
    """Fused GN systems from packed operands: (R, 8, 8) [and (R, 2) stats].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``gn_system_packed.launches`` counts those calls) or raise."""
    if tgtd.shape[0] == 0:
        raise ValueError("the target is empty")
    if src8.device.type == "cpu":
        M, stats = gn_system_reference(src8, tgtd, tn, Ts, max_correspondence_distance, huber_delta)
        return (M, stats) if return_stats else M
    if src8.device.type != "cuda":
        raise ValueError(f"gn_system_packed runs on CPU or CUDA tensors, not {src8.device}")
    _check(src8, tgtd, tn, Ts)
    R, Np, _ = src8.shape
    if R == 0 or Np == 0:
        M, stats = src8.new_zeros((R, 8, 8)), src8.new_zeros((R, 2))
    else:  # the kernels write every entry
        M, stats = torch.empty((R, 8, 8), device=src8.device), torch.empty((R, 2), device=src8.device)
        launch = _launcher()
        Mp = tgtd.shape[0]
        plan = launch_plan(R, Np, Mp, sm_count(src8.device.index))
        Ts = Ts.contiguous()
        nn = torch.empty((R, plan.splits, Np, 2), dtype=torch.int32, device=src8.device)
        partials = torch.empty((R, -(-Np // SYSTEM_THREADS), 38), dtype=torch.float32,
                               device=src8.device)
        with torch.cuda.device(src8.device):
            stream = torch.cuda.current_stream(src8.device).cuda_stream
            err = launch(src8.data_ptr(), tgtd.data_ptr(), tn.data_ptr(), Ts.data_ptr(),
                         max_correspondence_distance**2, huber_delta, R, Np, Mp, plan.splits,
                         plan.split_rows, nn.data_ptr(), partials.data_ptr(), M.data_ptr(),
                         stats.data_ptr(), stream)
        if err:
            raise RuntimeError(f"icp_gn kernel launch failed: CUDA error {err}")
        gn_system_packed.launches += 1
    return (M, stats) if return_stats else M


gn_system_packed.launches = 0


def gn_system(src_t, src_mask, target, target_normals, target_mask,
              max_correspondence_distance: float, huber_delta: float,
              block: int = 512, return_stats: bool = False):
    """One-shot form (``gn_system_pallas``): packs the operands and runs
    with identity poses. Iterating callers pack once and loop over
    ``gn_system_packed``."""
    R = src_t.shape[0]
    src8 = pack_source(src_t, src_mask, block=block)
    tgtd, tn = pack_target(target, target_normals, target_mask)
    Ts = torch.eye(4, dtype=src_t.dtype, device=src_t.device).expand(R, 4, 4).contiguous()
    return gn_system_packed(src8, tgtd, tn, Ts, max_correspondence_distance, huber_delta,
                            return_stats=return_stats)


def gn_system_oracle(src_t, src_mask, target, target_normals, target_mask,
                     max_correspondence_distance: float, huber_delta: float,
                     return_stats: bool = False):
    """The same system by gather (``gn_system_oracle``): brute NN with
    ``|q|^2 - 2 q.r + |r|^2``, then the residual and the 8x8 sum."""
    idx, d2 = _nn.nearest_neighbor(src_t, target, target_mask)
    q = target[idx]
    n = target_normals[idx]
    gate = src_mask & (d2 <= max_correspondence_distance**2)
    r = torch.sum(n * (src_t - q), dim=-1)
    w = gate * _huber_weight(r, huber_delta)
    jhat = torch.cat([n, torch.linalg.cross(src_t, n, dim=-1), r[..., None],
                      torch.ones_like(r)[..., None]], dim=-1)
    M = torch.sum((jhat * w[..., None])[..., :, None] * jhat[..., None, :], dim=-3)
    if return_stats:
        g = gate.to(r.dtype)
        return M, torch.stack([g.sum(dim=-1), (d2 * g).sum(dim=-1)], dim=-1)
    return M
