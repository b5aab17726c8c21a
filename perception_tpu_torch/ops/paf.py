"""Part-affinity-field scoring and people assembly.

Counterpart of ``perception_tpu/ops/paf.py``. Every function takes
leading batch dimensions, so a batch of frames decodes in one call.

* ``paf_pair_scores``: the line integral of the PAF along every candidate
  limb, sampled at T points and dotted with the limb's unit direction,
  with a success ratio of samples above threshold.
* ``greedy_match``: one-to-one greedy assignment, a fixed number of masked
  argmax trips (``argmax`` takes the first of equal maxima, as JAX does).
* ``assemble_people``: min-label propagation over the accepted limbs, 16
  fixed rounds, then the people ranked by part count.

The JAX package samples the PAF with one-hot matmuls (``_bilinear_mxu``,
a TPU workaround for slow gathers); the port gathers the four corners and
interpolates in that form's order, rows (y) first, then columns (x).
``.at[].min`` and ``.at[].max`` become ``scatter_reduce_`` with ``amin``
and ``amax`` over the initial values; segment sums are ``scatter_add_``:
exact for the integer counts, and in another order (CUDA's atomics) for
the float limb scores. Means are a sum times 1/n, as under ``jit``. No
loop reads the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perception_tpu_torch.ops.features import _top_k


def _clip_bound(size: int) -> float:
    """``size - 1.001`` as JAX clips with it: a Python double rounded to
    float32."""
    return float(torch.tensor(size - 1.001, dtype=torch.float32))


def _bilinear(fields: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (..., C, H, W) fields at (..., S) float coords -> (..., C, S);
    coordinates are clamped to the borders."""
    H, W = fields.shape[-2:]
    x = torch.clamp(x, 0.0, _clip_bound(W))
    y = torch.clamp(y, 0.0, _clip_bound(H))
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None, :]
    fy = (y - y0)[..., None, :]
    flat = fields.flatten(-2)
    C = fields.shape[-3]

    def at(yy, xx):
        idx = (yy * W + xx)[..., None, :].expand(*yy.shape[:-1], C, yy.shape[-1])
        return flat.gather(-1, idx)

    # Rows first: (1 - fy) f[y0] + fy f[y0 + 1], at x0 and at x0 + 1.
    r0 = at(y0, x0) * (1 - fy) + at(y0 + 1, x0) * fy
    r1 = at(y0, x0 + 1) * (1 - fy) + at(y0 + 1, x0 + 1) * fy
    return r0 * (1 - fx) + r1 * fx


def paf_pair_scores(
    paf_x: torch.Tensor,
    paf_y: torch.Tensor,
    a_xy: torch.Tensor,
    a_mask: torch.Tensor,
    b_xy: torch.Tensor,
    b_mask: torch.Tensor,
    num_samples: int = 10,
    sample_threshold: float = 0.05,
    min_success_ratio: float = 0.8,
) -> torch.Tensor:
    """Score all (Ka, Kb) candidate limbs of one limb type.

    paf_x/paf_y: (..., H, W) affinity field; a_xy (..., Ka, 2), b_xy
    (..., Kb, 2). Returns (..., Ka, Kb) scores; invalid pairs get -1.
    """
    Ka, Kb = a_xy.shape[-2], b_xy.shape[-2]
    lead = a_xy.shape[:-2]
    d = b_xy[..., None, :, :] - a_xy[..., :, None, :]  # (..., Ka, Kb, 2)
    norm = torch.linalg.vector_norm(d, dim=-1)
    u = d / torch.clamp(norm[..., None], min=1e-6)

    ts = torch.linspace(0.0, 1.0, num_samples, device=d.device)
    pos = a_xy[..., :, None, None, :] + ts[:, None] * d[..., None, :]  # (..., Ka, Kb, T, 2)
    both = _bilinear(
        torch.stack([paf_x, paf_y], dim=-3),
        pos[..., 0].reshape(lead + (-1,)),
        pos[..., 1].reshape(lead + (-1,)),
    )  # (..., 2, Ka*Kb*T)
    sx = both[..., 0, :].reshape(lead + (Ka, Kb, num_samples))
    sy = both[..., 1, :].reshape(lead + (Ka, Kb, num_samples))
    dots = sx * u[..., 0:1] + sy * u[..., 1:2]

    inv_t = 1.0 / num_samples
    success = (dots > sample_threshold).float().sum(dim=-1) * inv_t
    score = dots.sum(dim=-1) * inv_t
    ok = (
        (success >= min_success_ratio)
        & (norm > 1e-3)
        & a_mask[..., :, None]
        & b_mask[..., None, :]
    )
    return torch.where(ok, score, torch.full_like(score, -1.0))


class LimbMatches(NamedTuple):
    a_idx: torch.Tensor  # (..., E) peak index at part A
    b_idx: torch.Tensor  # (..., E) peak index at part B
    score: torch.Tensor  # (..., E)
    mask: torch.Tensor   # (..., E)


def greedy_match(scores: torch.Tensor, max_connections: int = 16) -> LimbMatches:
    """One-to-one greedy assignment on (..., Ka, Kb) score matrices:
    accept the global best, kill its row and column, ``min(E, Ka, Kb)``
    times (the sort-by-score-and-accept of the reference)."""
    Ka, Kb = scores.shape[-2:]
    E = min(max_connections, min(Ka, Kb))
    rows = torch.arange(Ka, device=scores.device)[:, None]
    cols = torch.arange(Kb, device=scores.device)[None, :]
    s, dead = scores, torch.full_like(scores, -1.0)
    ais, bis, vals = [], [], []
    for _ in range(E):
        flat = s.flatten(-2)
        best = torch.argmax(flat, dim=-1, keepdim=True)
        vals.append(flat.gather(-1, best)[..., 0])
        ai = torch.div(best, Kb, rounding_mode="floor")
        bi = best - ai * Kb
        ais.append(ai[..., 0])
        bis.append(bi[..., 0])
        kill = (rows == ai[..., None]) | (cols == bi[..., None])
        s = torch.where(kill, dead, s)
    pad = max_connections - E
    lead = scores.shape[:-2]

    def padded(items, dtype):
        out = torch.stack(items, dim=-1).to(dtype) if items else scores.new_zeros(lead + (0,), dtype=dtype)
        return torch.cat([out, out.new_zeros(lead + (pad,))], dim=-1) if pad else out

    score = padded(vals, scores.dtype)
    return LimbMatches(
        a_idx=padded(ais, torch.int32),
        b_idx=padded(bis, torch.int32),
        score=score,
        mask=torch.cat([score[..., :E] > 0, score.new_zeros(lead + (pad,), dtype=torch.bool)], dim=-1),
    )


class People(NamedTuple):
    keypoints: torch.Tensor  # (..., Pmax, P, 3) (x, y, score); 0 where absent
    num_parts: torch.Tensor  # (..., Pmax) parts found per person
    score: torch.Tensor      # (..., Pmax) mean limb score
    mask: torch.Tensor       # (..., Pmax) person valid


def assemble_people(
    limb_pairs: torch.Tensor,     # (Lb, 2) part indices per limb type
    matches_a: torch.Tensor,      # (..., Lb, E) peak idx at part pair[0]
    matches_b: torch.Tensor,      # (..., Lb, E)
    matches_score: torch.Tensor,  # (..., Lb, E)
    matches_mask: torch.Tensor,   # (..., Lb, E)
    peaks_xy: torch.Tensor,       # (..., P, K, 2)
    peaks_score: torch.Tensor,    # (..., P, K)
    peaks_mask: torch.Tensor,     # (..., P, K)
    num_parts: int,
    max_peaks: int,
    max_people: int = 16,
    min_person_parts: int = 3,
) -> People:
    """Union accepted limbs into skeletons via min-label propagation."""
    P, K = num_parts, max_peaks
    N = P * K
    lead = peaks_mask.shape[:-2]
    dev = peaks_mask.device
    pmask = peaks_mask.reshape(-1, N)
    B = pmask.shape[0]
    arange_n = torch.arange(N, device=dev)
    node_ids = torch.where(pmask, arange_n, N)  # (B, N) int64

    pairs = limb_pairs.to(dev, torch.int64)
    na = (pairs[:, 0:1] * K + matches_a.long().reshape(B, *matches_a.shape[-2:])).reshape(B, -1)
    nb = (pairs[:, 1:2] * K + matches_b.long().reshape(B, *matches_b.shape[-2:])).reshape(B, -1)
    em = matches_mask.reshape(B, -1)
    na = torch.where(em, na, N).clamp(0, N - 1)
    nb = torch.where(em, nb, N).clamp(0, N - 1)

    for _ in range(16):
        m = torch.minimum(node_ids.gather(1, na), node_ids.gather(1, nb))
        m = torch.where(em, m, N)
        node_ids = node_ids.scatter_reduce(1, na, m, "amin", include_self=True)
        node_ids = node_ids.scatter_reduce(1, nb, m, "amin", include_self=True)
        node_ids = torch.minimum(node_ids, node_ids.gather(1, node_ids.clamp(0, N - 1)))  # pointer jumping

    # Person roots ranked by part count.
    seg = node_ids.clamp(0, N)
    counts = torch.zeros(B, N + 1, dtype=torch.int32, device=dev).scatter_add_(
        1, seg, (node_ids < N).int())[:, :N]
    # Sum of limb scores per root (a limb counts for its node A's root).
    root_of_a = torch.where(em, node_ids.gather(1, na), N).clamp(0, N)
    ms = matches_score.reshape(B, -1)
    limb_scores = torch.zeros(B, N + 1, dtype=ms.dtype, device=dev).scatter_add_(
        1, root_of_a, torch.where(em, ms, torch.zeros_like(ms)))[:, :N]
    limb_counts = torch.zeros(B, N + 1, dtype=ms.dtype, device=dev).scatter_add_(
        1, root_of_a, em.to(ms.dtype))[:, :N]

    rank_score = torch.where(counts >= min_person_parts, counts, -1)
    top_counts, roots = _top_k(rank_score, max_people)  # (B, Pmax)
    person_valid = top_counts >= min_person_parts

    person_of_root = torch.full((B, N + 1), -1, dtype=torch.int64, device=dev)
    person_of_root = person_of_root.scatter(
        1, torch.where(person_valid, roots, N),
        torch.where(person_valid, torch.arange(max_people, device=dev), -1))
    node_person = person_of_root.gather(1, seg)  # (B, N)

    # Keypoints into (Pmax, P, 3), max-combined per component so the
    # strongest value wins a duplicated (person, part).
    part_of_node = torch.div(arange_n, K, rounding_mode="floor")
    write = (node_person >= 0) & pmask
    tgt = torch.where(write, node_person * P + part_of_node, max_people * P)
    vals = torch.cat([peaks_xy.reshape(B, N, 2), peaks_score.reshape(B, N, 1)], dim=-1)
    vals = torch.where(write[..., None], vals, torch.full_like(vals, float("-inf")))
    kp = torch.zeros(B, max_people * P + 1, 3, dtype=vals.dtype, device=dev).scatter_reduce(
        1, tgt[..., None].expand(B, N, 3), vals, "amax", include_self=True)
    kp = torch.where(torch.isfinite(kp), kp, torch.zeros_like(kp))[:, :max_people * P]

    mean_scores = limb_scores.gather(1, roots) / torch.clamp(limb_counts.gather(1, roots), min=1.0)
    return People(
        keypoints=kp.reshape(lead + (max_people, P, 3)),
        num_parts=torch.where(person_valid, top_counts, 0).reshape(lead + (max_people,)),
        score=torch.where(person_valid, mean_scores, torch.zeros_like(mean_scores)).reshape(lead + (max_people,)),
        mask=person_valid.reshape(lead + (max_people,)),
    )
