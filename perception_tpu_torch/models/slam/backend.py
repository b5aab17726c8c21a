"""SLAM back end: local bundle adjustment + pose-graph optimization.

Counterpart of ``perception_tpu/models/slam/backend.py``:

- **Local BA**: Levenberg-Marquardt over M keyframe poses and L
  landmarks with a dense Schur complement. Per-observation Jacobians are
  built batched, the pose and landmark blocks are summed per segment,
  landmarks are eliminated by batched closed-form 3x3 inverses, and the
  reduced (6M, 6M) camera system is solved. Pose 0 is frozen (gauge).
- **Pose graph**: Gauss-Newton on SE(3) edge residuals
  r_e = log(T_meas^-1 T_i^-1 T_j) with forward-mode Jacobian blocks and a
  dense (6N, 6N) solve. Node 0 is frozen.

What differs from the JAX package, and why:

- Lookups by row index are row gathers (bit-identical to the JAX
  package's one-hot matmuls). Sums over observations or edges stay
  one-hot matmuls: deterministic on the card with TF32 off, where
  ``index_add_`` adds in atomic order.
- BA's reduced camera system is solved as the JAX package solves it, by
  unpivoted Gauss-Jordan with a guarded pivot (``_gauss_solve``): in
  float32 the gauged system can be indefinite, and LU with partial
  pivoting then meets an exact zero pivot and returns a non-finite step
  whose cost comes out as 0.0, where the guarded pivot keeps the step
  finite. Its 6M = 30 steps are ~7 small launches each. The pose graph's
  ``H + I`` is positive definite, so it keeps ``torch.linalg.solve_ex``
  (LU, no wait for the card): Gauss-Jordan there would be ~2,000 small
  launches per iteration.
- The edge Jacobians are forward-mode derivatives of the edge-batched
  residual along the 12 unit tangents, taken in one pass over a batch of
  12 x E duals (``torch.autograd.forward_ad``); the JAX package vmaps a
  per-edge ``jacfwd``.
- ``lax.scan`` loops are Python loops of fixed count; the LM accept and
  reject are tensor ``where``s, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from perception_tpu_torch._tensor import const, consts
from perception_tpu_torch.geometry import se3
from perception_tpu_torch.ops.pnp import huber_weight


class BAProblem(NamedTuple):
    poses_wc: torch.Tensor    # (M, 4, 4) world <- camera
    landmarks: torch.Tensor   # (L, 3) world points
    obs_pose: torch.Tensor    # (O,) int pose index per observation
    obs_lm: torch.Tensor      # (O,) int landmark index
    obs_uv: torch.Tensor      # (O, 2) measured pixels
    obs_mask: torch.Tensor    # (O,) valid
    # Optional RGB-D depth channel (None = pure reprojection): the
    # residual zw * (z_pred - z_meas) pins the two-view scale gauge.
    obs_z: Optional[torch.Tensor] = None   # (O,) measured depth (m)
    obs_zw: Optional[torch.Tensor] = None  # (O,) depth-residual weight (px/m, 0 = none)


class BAResult(NamedTuple):
    poses_wc: torch.Tensor
    landmarks: torch.Tensor
    initial_cost: torch.Tensor  # () mean squared reprojection error (px^2)
    final_cost: torch.Tensor


def _onehot(ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(len(ids), n) one-hot selector: the segment sums are matmuls with it."""
    return (ids[:, None] == torch.arange(n, device=ids.device)[None, :]).to(dtype)


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    det = torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    return co / det[..., None, None]


def _gauge(A: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Freeze the first 6 unknowns of A x = b at 0: their rows and columns
    of A zeroed, their diagonal 1, their entries of b 0."""
    g = torch.arange(A.shape[0], device=A.device) < 6
    A = torch.where(g[:, None] | g[None, :], torch.eye(A.shape[0], device=A.device), A)
    return A, torch.where(g, torch.zeros((), device=b.device), b)


def _gauss_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (b a vector) by unpivoted Gauss-Jordan over the
    (n, n+1) augmented matrix, as the JAX package's ``_gauss_solve``: n
    sequential steps, each pivot row divided by its pivot, or by 1 where
    |pivot| <= 1e-20, so the result stays finite. No wait for the card."""
    n = A.shape[0]
    M = torch.cat([A, b[:, None]], dim=1)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    for k in range(n):
        piv = M[k, k]
        row = M[k] / torch.where(torch.abs(piv) > 1e-20, piv, one)
        M = M - (M[:, k] - eye[k])[:, None] * row[None, :]
    return M[:, n]


def _solve_gauged(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the gauged A x = b by ``solve_ex`` (LU with partial pivoting,
    no wait for the card), for positive definite A."""
    A, b = _gauge(A, b)
    return torch.linalg.solve_ex(A, b[:, None])[0][:, 0]


def _proj_residuals(T_cw, landmarks, obs_pose, obs_lm, obs_uv, obs_mask,
                    fx, fy, cx, cy, obs_z=None, obs_zw=None):
    """Residuals + camera-frame points (O, 3) + per-obs R_cw.

    Residuals are (O, 2) for pure reprojection or (O, 3) with the
    weighted depth row appended when ``obs_z``/``obs_zw`` are given.
    ``fx``.. are tensors on the problem's device."""
    R = T_cw[obs_pose, :3, :3]      # (O, 3, 3)
    t = T_cw[obs_pose, :3, 3]       # (O, 3)
    X = landmarks[obs_lm]
    pc = (R @ X[:, :, None])[:, :, 0] + t
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    r = torch.stack([u, v], dim=-1) - obs_uv
    if obs_z is not None:
        rz = obs_zw * (pc[:, 2] - obs_z)
        r = torch.cat([r, rz[:, None]], dim=-1)
    r = torch.where(obs_mask[:, None] & (pc[:, 2:3] > 1e-3), r, torch.zeros((), device=r.device))
    return r, pc, R


def ba_blocks(T_cw, lms, obs_pose, obs_lm, obs_uv, obs_mask,
              fx, fy, cx, cy, M: int, L: int, huber_px: float,
              obs_z=None, obs_zw=None, oh_pose=None, oh_lm=None):
    """Per-iteration normal-equation blocks from a set of observations.

    Returns (Hpp (M,6,6), Hll (L,3,3), U (L,M,6,3), bp (M,6), bl (L,3)):
    pure sums over observations, so an observation set split over
    processes just all-reduces these outputs. Pass the
    iteration-invariant one-hot selectors ``oh_pose`` (O, M) and
    ``oh_lm`` (O, L) to build them once per solve."""
    if oh_pose is None:
        oh_pose = _onehot(obs_pose, M)
    if oh_lm is None:
        oh_lm = _onehot(obs_lm, L)
    fx, fy, cx, cy = consts(lms, fx, fy, cx, cy)
    r, pc, Rcw = _proj_residuals(T_cw, lms, obs_pose, obs_lm, obs_uv, obs_mask,
                                 fx, fy, cx, cy, obs_z, obs_zw)
    z = torch.clamp(pc[:, 2], min=1e-6)
    zero = torch.zeros_like(z)
    rows = [
        torch.stack([fx / z, zero, -fx * pc[:, 0] / (z * z)], dim=-1),
        torch.stack([zero, fy / z, -fy * pc[:, 1] / (z * z)], dim=-1),
    ]
    if obs_z is not None:
        # d r_z / d pc = [0, 0, zw] (zw is constant per observation).
        rows.append(torch.stack([zero, zero, obs_zw], dim=-1))
    Jproj = torch.stack(rows, dim=-2)
    # Pose block: left-mult update T_cw <- exp(xi) T_cw, so
    # d pc/d xi = [I | -hat(pc)] (3, 6).
    I3 = torch.eye(3, device=z.device).expand(r.shape[0], 3, 3)
    dpc_dxi = torch.cat([I3, -se3.hat(pc)], dim=-1)  # (O, 3, 6)
    Jp = Jproj @ dpc_dxi                              # (O, 2|3, 6)
    Jl = Jproj @ Rcw                                  # (O, 2|3, 3)

    # Huber IRLS weights on the residual norm.
    w = huber_weight(torch.linalg.vector_norm(r, dim=-1), huber_px) * obs_mask
    Jp = Jp * w[:, None, None]
    Jl_w = Jl * w[:, None, None]

    # Block sums as (segments, O) x (O, D) matmuls.
    hpp_data = ((Jp.transpose(1, 2) @ Jp) / torch.clamp(w, min=1e-9)[:, None, None]).reshape(-1, 36)
    Hpp = (oh_pose.T @ hpp_data).reshape(M, 6, 6)
    Hll = (oh_lm.T @ (Jl_w.transpose(1, 2) @ Jl).reshape(-1, 9)).reshape(L, 3, 3)
    bp = -(oh_pose.T @ torch.einsum("oai,oa->oi", Jp, r))
    bl = -(oh_lm.T @ torch.einsum("oai,oa->oi", Jl_w, r))
    Wkl = (Jp.transpose(1, 2) @ Jl).reshape(-1, 18)  # carries w once
    # U (L, M, 6, 3): per-pose masked landmark sums.
    U = torch.stack([(oh_lm.T @ (Wkl * oh_pose[:, m:m + 1])).reshape(L, 6, 3) for m in range(M)], dim=1)
    return Hpp, Hll, U, bp, bl


def ba_schur_solve(Hpp, Hll, U, bp, bl, lam, M: int, L: int):
    """Eliminate landmarks, solve the reduced camera system, and
    back-substitute. Returns (dxi (M,6), dX (L,3), seen (L,))."""
    dev = Hpp.device
    eye3 = torch.eye(3, device=dev).expand(L, 3, 3)
    Hll_d = Hll + lam * eye3
    seen = torch.diagonal(Hll, dim1=1, dim2=2).sum(-1) > 1e-9
    Hll_inv = _inv3(torch.where(seen[:, None, None], Hll_d, eye3))

    diag = Hpp + lam * torch.eye(6, device=dev).expand(M, 6, 6)
    S = torch.zeros((M, 6, M, 6), device=dev)
    S[torch.arange(M, device=dev), :, torch.arange(M, device=dev), :] = diag
    UH = torch.einsum("lkac,lcd->lkad", U, Hll_inv)          # (L, M, 6, 3)
    S = S - torch.einsum("lkad,lmbd->kamb", UH, U)
    rhs = bp - torch.einsum("lkad,ld->ka", UH, bl)

    # Gauge: freeze pose 0.
    dxi = _gauss_solve(*_gauge(S.reshape(6 * M, 6 * M), rhs.reshape(6 * M))).reshape(M, 6)
    dX = torch.einsum("lcd,ld->lc", Hll_inv, bl - torch.einsum("lkdc,kd->lc", U, dxi))
    dX = torch.where(seen[:, None], dX, torch.zeros((), device=dev))
    return dxi, dX, seen


def bundle_adjust(
    problem: BAProblem,
    fx, fy, cx, cy,
    iterations: int = 10,
    damping: float = 1e-3,
    huber_px: float = 3.0,
) -> BAResult:
    M = problem.poses_wc.shape[0]
    L = problem.landmarks.shape[0]
    like = problem.landmarks
    fx, fy, cx, cy = consts(like, fx, fy, cx, cy)
    obs_pose = problem.obs_pose.to(torch.int64)
    obs_lm = problem.obs_lm.to(torch.int64)

    T_cw = se3.inverse(problem.poses_wc)
    # Iteration-invariant one-hot selectors for the segment sums.
    oh_pose = _onehot(obs_pose, M)
    oh_lm = _onehot(obs_lm, L)
    n = torch.clamp(torch.sum(problem.obs_mask), min=1)

    def cost(T, lms):
        r, _, _ = _proj_residuals(T, lms, obs_pose, obs_lm, problem.obs_uv, problem.obs_mask,
                                  fx, fy, cx, cy, problem.obs_z, problem.obs_zw)
        return torch.sum(r * r) / n

    lms = problem.landmarks
    lam = const(damping, like)
    c = c0 = cost(T_cw, lms)
    for _ in range(iterations):
        # The accepted cost rides the loop: one residual evaluation per iteration.
        Hpp, Hll, U, bp, bl = ba_blocks(
            T_cw, lms, obs_pose, obs_lm, problem.obs_uv, problem.obs_mask,
            fx, fy, cx, cy, M, L, huber_px, problem.obs_z, problem.obs_zw,
            oh_pose=oh_pose, oh_lm=oh_lm,
        )
        dxi, dX, _ = ba_schur_solve(Hpp, Hll, U, bp, bl, lam, M, L)
        T_new = se3.se3_exp(dxi) @ T_cw
        lms_new = lms + dX
        # LM: keep the step only if the cost decreased and stayed finite.
        c_new = cost(T_new, lms_new)
        better = (c_new < c) & torch.isfinite(c_new)
        T_cw = torch.where(better, T_new, T_cw)
        lms = torch.where(better, lms_new, lms)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        c = torch.where(better, c_new, c)
    return BAResult(poses_wc=se3.inverse(T_cw), landmarks=lms, initial_cost=c0, final_cost=c)


class PoseGraph(NamedTuple):
    poses_wc: torch.Tensor     # (N, 4, 4)
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    edge_T: torch.Tensor       # (E, 4, 4) measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,)
    edge_mask: torch.Tensor    # (E,)


def _edge_residual_12(d, Ti, Tj, Tm_inv, sw):
    """Residuals (..., 6) of edges under 12 perturbation dofs d (..., 12),
    6 per endpoint, right-multiplicative: T_k <- T_k exp(delta_k)."""
    T_i = Ti @ se3.se3_exp(d[..., :6])
    T_j = Tj @ se3.se3_exp(d[..., 6:])
    return se3.se3_log(Tm_inv @ se3.inverse(T_i) @ T_j) * sw[..., None]


def pose_graph_system_oh(Ti, Tj, Tm_inv, w):
    """Per-edge residuals + Jacobian blocks from looked-up endpoint poses:
    (r (E,6), Ji (E,6,6), Jj (E,6,6)). Masked edges carry w = 0, so their
    residual and both blocks are exactly zero.

    The Jacobian is the forward-mode derivative at d = 0 along the 12
    unit tangents, as one batch of 12 x E duals."""
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    E = Ti.shape[0]
    eye12 = torch.eye(12, dtype=Ti.dtype, device=Ti.device)
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.zeros((12, E, 12), dtype=Ti.dtype, device=Ti.device),
                           eye12[:, None, :].expand(12, E, 12))
        out = fwAD.unpack_dual(_edge_residual_12(d, Ti, Tj, Tm_inv, sw))
    J = out.tangent.permute(1, 2, 0)  # (E, 6, 12)
    return out.primal[0], J[:, :, :6], J[:, :, 6:]


def pose_graph_system(poses, edge_i, edge_j, Tm_inv, w):
    """``pose_graph_system_oh`` with the endpoint poses gathered by index."""
    return pose_graph_system_oh(poses[edge_i.long()], poses[edge_j.long()], Tm_inv, w)


def optimize_pose_graph(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (optimized poses (N,4,4), initial_cost, final_cost).

    Gauss-Newton with per-edge Jacobian blocks assembled into the
    (6N, 6N) normal matrix by one-hot matmuls, and a dense solve."""
    N = graph.poses_wc.shape[0]
    dev = graph.poses_wc.device
    Tm_inv = se3.inverse(graph.edge_T)
    w = (graph.edge_weight * graph.edge_mask).to(torch.float32)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    oh_i = _onehot(ei, N)   # (E, N)
    oh_j = _onehot(ej, N)
    oh_row = torch.cat([oh_i, oh_i, oh_j, oh_j])  # (4E, N)
    oh_col = torch.cat([oh_i, oh_j, oh_i, oh_j])
    oh_g = torch.cat([oh_i, oh_j]).T              # (N, 2E)
    n_edges = torch.clamp(torch.sum(graph.edge_mask), min=1)
    eye = damping * torch.eye(6 * N, device=dev)

    def cost(poses):
        r = se3.se3_log(Tm_inv @ se3.inverse(poses[ei]) @ poses[ej]) * sw[:, None]
        return torch.sum(r * r) / n_edges

    poses = graph.poses_wc
    c0 = c = cost(poses)
    for _ in range(iterations):
        r, Ji, Jj = pose_graph_system_oh(poses[ei], poses[ej], Tm_inv, w)
        Hii = Ji.transpose(1, 2) @ Ji
        Hij = Ji.transpose(1, 2) @ Jj
        Hjj = Jj.transpose(1, 2) @ Jj
        blocks = torch.cat([Hii.reshape(-1, 36), Hij.reshape(-1, 36),
                            Hij.transpose(1, 2).reshape(-1, 36), Hjj.reshape(-1, 36)])  # (4E, 36)
        # H[na, nb] = sum_e oh_row[e, na] oh_col[e, nb] block[e]
        scaled = (oh_col[:, :, None] * blocks[:, None, :]).reshape(blocks.shape[0], -1)  # (4E, N*36)
        Hb = (oh_row.T @ scaled).reshape(N, N, 6, 6)
        H = Hb.permute(0, 2, 1, 3).reshape(6 * N, 6 * N) + eye

        gi = -torch.einsum("eai,ea->ei", Ji, r)
        gj = -torch.einsum("eai,ea->ei", Jj, r)
        g = (oh_g @ torch.cat([gi, gj])).reshape(-1)

        # Gauge: freeze node 0.
        delta = _solve_gauged(H, g).reshape(N, 6)
        new_poses = poses @ se3.se3_exp(delta)
        c_new = cost(new_poses)
        better = c_new < c
        poses = torch.where(better, new_poses, poses)
        c = torch.where(better, c_new, c)
    poses = se3.orthonormalize_T(poses)  # long-lived state: stay on SE(3)
    return poses, c0, cost(poses)
