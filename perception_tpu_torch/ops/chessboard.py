"""In-house chessboard corner detection + grid ordering.

Counterpart of ``perception_tpu/ops/chessboard.py`` (the capability of the
reference's ``openpose/src/openpose/calibration/gridPatternFunctions.cpp``
without ``cv2.findChessboardCorners``):

  * **Saddle response** (device): a 16-point ring around every pixel by
    wrap-around shifts (``torch.roll``, as ``jnp.roll``), projected onto
    the cos(2phi)/sin(2phi) harmonics (strong at X-corners at any board
    rotation) less the cos(phi)/sin(phi) energy (strong at edges).
  * **NMS + subpixel** (device): a 5x5 local maximum with a raster-order
    tie-break, the top candidates in ``lax.top_k``'s order (ties to the
    lower index), and a gradient-orthogonality refinement over one gather
    of (K, 13, 13) windows.
  * **Lattice ordering** (host, numpy): greedy BFS over the candidates,
    a copy of the JAX package's; it takes its seeds from distances in
    candidate order, so the order of equal corners matters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.features import _top_k


def saddle_response(gray: torch.Tensor, radius: int = 4, samples: int = 16) -> torch.Tensor:
    """(H, W) image -> (H, W) X-corner (saddle) response, rotation
    invariant: shifts and elementwise math only."""
    img = gray.to(torch.float32)
    img = img / torch.clamp(torch.amax(torch.abs(img)), min=1e-6)
    phis = 2.0 * np.pi * np.arange(samples) / samples
    a = torch.zeros_like(img)
    b = torch.zeros_like(img)
    c = torch.zeros_like(img)
    d = torch.zeros_like(img)
    f32 = np.float32
    for phi in phis:
        dy = int(round(radius * np.sin(phi)))
        dx = int(round(radius * np.cos(phi)))
        s = torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
        a = a + s * float(f32(np.cos(2 * phi)))
        b = b + s * float(f32(np.sin(2 * phi)))
        c = c + s * float(f32(np.cos(phi)))
        d = d + s * float(f32(np.sin(phi)))
    saddle = a * a + b * b
    edge = c * c + d * d
    return torch.clamp(saddle - edge, min=0.0)


def find_corner_candidates(
    gray: torch.Tensor,
    max_corners: int,
    radius: int = 4,
    nms_window: int = 5,
    rel_threshold: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``max_corners`` saddle points of an (H, W) image: ((max_corners,
    2) float (u, v) subpixel coordinates, (max_corners,) bool mask), in
    descending response, ties to the lower raster index."""
    resp = saddle_response(gray, radius=radius)
    h, w = resp.shape
    # Local maximum over the window: strictly above raster-earlier
    # neighbours, at least raster-later ones, so a flat plateau gives one peak.
    pad = nms_window // 2
    padded = F.pad(resp[None, None], (pad, pad, pad, pad), value=float("-inf"))[0, 0]
    is_peak = torch.ones_like(resp, dtype=torch.bool)
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            if (dy, dx) < (0, 0):
                is_peak &= resp > nb
            else:
                is_peak &= resp >= nb
    # Drop the border band where the ring wraps around.
    bb = radius + 1
    vv = torch.arange(h, device=resp.device)[:, None]
    uu = torch.arange(w, device=resp.device)[None, :]
    interior = (vv >= bb) & (vv < h - bb) & (uu >= bb) & (uu < w - bb)
    is_peak &= (resp > rel_threshold * torch.amax(resp)) & interior
    score = torch.where(is_peak, resp, torch.full_like(resp, float("-inf"))).reshape(-1)
    vals, idx = _top_k(score, max_corners)
    pv = idx // w
    pu = idx % w

    # Gradient-orthogonality refinement (cornerSubPix's normal equations):
    # at a saddle every window gradient g(q) is orthogonal to q - p, so
    # p = (sum g g^T)^-1 sum g g^T q.
    img = gray.to(torch.float32)
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy = torch.zeros_like(img)
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    r = radius + 2
    win = 2 * r + 1
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    wy, wx = torch.meshgrid(offs, offs, indexing="ij")
    gauss = torch.exp(-(wx * wx + wy * wy) / const(2.0 * (0.6 * r) ** 2, img))

    yc = torch.clamp(pv, r, h - 1 - r)
    xc = torch.clamp(pu, r, w - 1 - r)
    steps = torch.arange(win, device=img.device)
    rows = (yc - r)[:, None, None] + steps[None, :, None]
    cols = (xc - r)[:, None, None] + steps[None, None, :]
    gxs = gx[rows, cols]  # (K, win, win)
    gys = gy[rows, cols]

    def wsum(t):
        return torch.sum(gauss * t, dim=(-2, -1))

    a = wsum(gxs * gxs)
    b = wsum(gxs * gys)
    c = wsum(gys * gys)
    bx = wsum(gxs * gxs * wx + gxs * gys * wy)
    by = wsum(gxs * gys * wx + gys * gys * wy)
    det = a * c - b * b
    solvable = det > 1e-12
    zero = torch.zeros_like(det)
    ox = torch.where(solvable, (c * bx - b * by) / det, zero)
    oy = torch.where(solvable, (a * by - b * bx) / det, zero)
    ok = (torch.abs(ox) < r) & (torch.abs(oy) < r)
    ux = torch.where(ok, xc + ox, pu.to(torch.float32))
    uy = torch.where(ok, yc + oy, pv.to(torch.float32))
    return torch.stack([ux, uy], dim=-1), torch.isfinite(vals)


def order_grid(
    candidates: np.ndarray, rows: int, cols: int, tol: float = 0.35
) -> Optional[np.ndarray]:
    """Assign lattice coordinates to candidate corners by greedy BFS with
    locally estimated step vectors; return (rows*cols, 2) corners
    row-major (left-to-right, top-to-bottom in image space) or None.
    Host numpy, a copy of the JAX package's."""
    pts = np.asarray(candidates, np.float64)
    n = len(pts)
    if n < rows * cols:
        return None

    # kNN table.
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1)[:, :8]

    def try_seed(seed: int) -> Optional[np.ndarray]:
        # Step vectors from the seed's nearest neighbors: u = nearest,
        # v = most perpendicular with similar length.
        u = pts[knn[seed, 0]] - pts[seed]
        ul = np.linalg.norm(u)
        v = None
        for cand in knn[seed, 1:]:
            w = pts[cand] - pts[seed]
            wl = np.linalg.norm(w)
            if wl > 1.6 * ul or wl < 0.6 * ul:
                continue
            cosang = abs(u @ w) / (ul * wl)
            if cosang < 0.35:
                v = w
                break
        if v is None:
            return None

        coords = {seed: (0, 0)}
        claimed = {(0, 0): seed}
        queue = [seed]
        steps = {seed: (u.copy(), v.copy())}
        while queue:
            i = queue.pop()
            ui, vi = steps[i]
            ci = np.array(coords[i])
            for dvec, dij in ((ui, (1, 0)), (-ui, (-1, 0)), (vi, (0, 1)), (-vi, (0, -1))):
                tgt = tuple(ci + dij)
                if tgt in claimed:
                    continue
                pred = pts[i] + dvec
                j = int(np.argmin(((pts - pred) ** 2).sum(-1)))
                if j in coords:
                    continue
                err = np.linalg.norm(pts[j] - pred)
                if err > tol * np.linalg.norm(dvec):
                    continue
                coords[j] = tgt
                claimed[tgt] = j
                # Local step update: the actual delta along this axis.
                delta = pts[j] - pts[i]
                if dij[0] != 0:
                    steps[j] = (delta * dij[0], vi)
                else:
                    steps[j] = (ui, delta * dij[1])
                queue.append(j)

        if len(coords) < rows * cols:
            return None
        ij = np.array([coords[k] for k in coords])
        ids = np.array(list(coords))
        imin, jmin = ij.min(axis=0)
        ij = ij - (imin, jmin)
        ispan, jspan = ij.max(axis=0) + 1
        # Accept either orientation of the board.
        if (ispan, jspan) == (cols, rows):
            pass
        elif (ispan, jspan) == (rows, cols):
            ij = ij[:, ::-1]
            ispan, jspan = jspan, ispan
        else:
            return None
        grid = np.full((jspan, ispan, 2), np.nan)
        for (gi, gj), k in zip(ij, ids):
            grid[gj, gi] = pts[k]
        if np.isnan(grid).any():
            return None
        # Canonical orientation: rows scan top-to-bottom, cols left-to-right.
        row_dir = grid[0, -1] - grid[0, 0]
        col_dir = grid[-1, 0] - grid[0, 0]
        if abs(row_dir[0]) < abs(row_dir[1]):  # rows should advance in u
            grid = grid.transpose(1, 0, 2)
            row_dir = grid[0, -1] - grid[0, 0]
            col_dir = grid[-1, 0] - grid[0, 0]
            if grid.shape[:2] != (rows, cols):
                return None
        if grid.shape[:2] != (rows, cols):
            return None
        if row_dir[0] < 0:
            grid = grid[:, ::-1]
        if col_dir[1] < 0:
            grid = grid[::-1]
        return grid.reshape(-1, 2).astype(np.float32)

    center = np.argmin(((pts - pts.mean(0)) ** 2).sum(-1))
    for seed in [int(center)] + list(np.argsort(d2[center])[: min(6, n)]):
        out = try_seed(int(seed))
        if out is not None:
            return out
    return None


def detect_chessboard_native(
    gray, rows: int, cols: int, radius: int = 4, device="cuda"
) -> Optional[np.ndarray]:
    """Saddle response + NMS on the device, lattice ordering on the host:
    (rows*cols, 2) row-major corners or None, as
    ``calibration.detect_chessboard``. ``gray`` is an (H, W) array or
    tensor; a tensor stays on its device. One host read (the candidates)."""
    need = rows * cols
    cap = need + max(need // 2, 8)
    if not isinstance(gray, torch.Tensor):
        gray = torch.from_numpy(np.asarray(gray, np.float32)).to(device, non_blocking=True)
    uv, mask = find_corner_candidates(gray.to(torch.float32), cap, radius)
    both = torch.cat([uv, mask[:, None].to(uv.dtype)], dim=1).cpu().numpy()
    cand = both[both[:, 2] > 0, :2]
    if len(cand) < need:
        return None
    return order_grid(cand, rows, cols)
