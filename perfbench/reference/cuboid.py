"""Plain reference of the cuboid detector on a batch of depth frames.

The same steps as the reference node's ``cuboid_detection`` and the
program's ``CuboidConfig``, written from the algorithm, frame by frame:
stride decimation and backprojection, passthrough z/x, compaction to
``pre_capacity`` (an evenly spaced subset past it), a voxel grid's
centroids in voxel-id order, an evenly spaced ``work_capacity`` prefix,
RANSAC on the given triplets (first best count wins) with a
least-squares refit, the off-plane points compacted to ``box_capacity``,
the densest coarse cell's blob, yaw-restart point-to-plane ICP against
the template, and the acceptance gate and the box's corners. The
template's features (voxel centroids, kNN-PCA normals) are worked out
again here from the template's points.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.common import (SENTINEL, Precision, full_float32, gn_step, huber_weight,
                                        inverse, make_T, nearest, transform)


def template_features(points: np.ndarray, cfg: dict):
    """Voxel centroids (origin -5 m, ``voxel_size``) in cell order, cut to
    ``template_capacity``, and their k=8 nearest-neighbour PCA normals
    facing a viewpoint 10 m behind the camera. Returns numpy float32
    (points (n, 3), normals (n, 3))."""
    vs = cfg["voxel_size"]
    keys = np.floor((points.astype(np.float32) + np.float32(5.0)) / np.float32(vs)).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, points.astype(np.float64))
    cents = (sums / np.bincount(inv)[:, None]).astype(np.float32)[: cfg["template_capacity"]]
    # float32 distances and numpy's default sort, as the node's template
    # step: equal distances on the grid-aligned faces keep one tie order.
    d2 = ((cents[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    nb = cents[np.argsort(d2, axis=1)[:, :8]]
    cen = (nb - nb.mean(axis=1, keepdims=True)).astype(np.float64)
    _, vecs = np.linalg.eigh(np.einsum("nki,nkj->nij", cen, cen))
    n = vecs[..., 0]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[((np.array([0.0, 0.0, -10.0]) - cents) * n).sum(1) < 0] *= -1.0
    return cents, n.astype(np.float32)


def _keep(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Which valid points an evenly spaced subset of ``capacity`` keeps:
    valid point of rank r stays iff floor(r * ratio) advances, ratio =
    capacity / count in float32."""
    cnt = int(mask.sum())
    if cnt <= capacity:
        return mask.clone()
    rank = (torch.cumsum(mask.to(torch.int64), 0) - 1).to(torch.float32)
    ratio = torch.tensor(capacity, dtype=torch.float32) / torch.tensor(cnt, dtype=torch.float32)
    ratio = ratio.to(mask.device)
    return mask & (torch.floor((rank + 1.0) * ratio) > torch.floor(rank * ratio))


def _pad(points: torch.Tensor, capacity: int):
    out = torch.full((capacity, 3), SENTINEL, dtype=points.dtype, device=points.device)
    out[: points.shape[0]] = points
    m = torch.zeros(capacity, dtype=torch.bool, device=points.device)
    m[: points.shape[0]] = True
    return out, m


def _voxel_centroids(p: torch.Tensor, vs: float) -> torch.Tensor:
    """Centroids of the occupied cells of a 1024^3 grid anchored one cell
    below the cloud's minimum, in cell-id order."""
    vs_t = torch.tensor(vs, dtype=torch.float32, device=p.device)
    origin = (torch.floor(p.amin(0) / vs_t) - 1.0) * vs_t
    c = torch.clamp(torch.floor((p - origin) / vs_t).to(torch.int64), 0, 1023)
    ids = (c[:, 0] * 1024 + c[:, 1]) * 1024 + c[:, 2]
    _, inv = torch.unique(ids, return_inverse=True)
    sums = torch.zeros((int(inv.max()) + 1, 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, inv, p.double())
    return (sums / torch.bincount(inv).double()[:, None]).to(torch.float32)


def _passthrough(points: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The points inside the z and x limits (inclusive)."""
    z, x = points[:, 2], points[:, 0]
    (zlo, zhi), (xlo, xhi) = cfg["z_limits"], cfg["x_limits"]
    return (z >= zlo) & (z <= zhi) & (x >= xlo) & (x <= xhi)


def _ransac(p, m, idx, threshold, prec: Precision):
    """Plane of one frame from given triplets: (n, d, inliers, valid)."""
    p0, p1, p2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    nrm = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    norm = torch.sqrt((nrm * nrm).sum(-1, keepdim=True))
    ok = norm[:, 0] > 1e-10
    nrm = nrm / torch.clamp(norm, min=1e-12)
    d = -(nrm * p0).sum(-1)
    dist = torch.abs(prec.mm(p, nrm.T) + d)
    score = ((dist <= threshold) & m[:, None]).sum(0)
    score = torch.where(ok, score, torch.full_like(score, -1))
    best = int(torch.argmax(score))
    n0, d0 = nrm[best], d[best]
    inl0 = (torch.abs(prec.mm(p, n0[:, None])[:, 0] + d0) <= threshold) & m
    w = inl0.double()
    cnt = torch.clamp(w.sum(), min=3.0)
    mean = (p.double() * w[:, None]).sum(0) / cnt
    cen = (p.double() - mean) * w[:, None]
    _, vecs = torch.linalg.eigh(cen.T @ cen / cnt)
    n = vecs[:, 0] / torch.linalg.vector_norm(vecs[:, 0])
    n = (n if float((n * n0.double()).sum()) >= 0 else -n).to(torch.float32)
    dd = -(n * mean.to(torch.float32)).sum()
    inl = (torch.abs(prec.mm(p, n[:, None])[:, 0] + dd) <= threshold) & m
    valid = int(score[best]) >= 10 and int(inl.sum()) >= 10
    return torch.cat([n, dd[None]]), inl, valid


def _blob(p, m, radius):
    """The points of one frame within ``radius`` of the centroid of its
    densest 5 cm cell (grid anchored at -5 m; the lowest cell id of equal
    counts)."""
    cell = torch.tensor(0.05, dtype=torch.float32, device=p.device)
    c = torch.clamp(torch.floor((p[m] - (-5.0)) / cell).to(torch.int64), 0, 255)
    ids = (c[:, 0] * 256 + c[:, 1]) * 256 + c[:, 2]
    uniq, inv, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    best = int(torch.argmax(counts))
    center = p[m][inv == best].double().mean(0).to(torch.float32)
    d2 = ((p - center) ** 2).sum(-1)
    return m & (d2 <= torch.tensor(radius * radius, dtype=torch.float32, device=p.device))


def _icp(src, smask, tpts, tnrm, cfg, prec: Precision):
    """Yaw-restart point-to-plane ICP of lanes src (L, N, 3) against the
    template; returns (pose template -> camera (L, k, 4, 4), fitness (L,
    k)) of every restart."""
    k = cfg["icp_restarts"]
    dev = src.device
    w = smask.to(torch.float32)
    cs = (src * w[..., None]).sum(-2) / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    ct = tpts.mean(0)
    ang = torch.arange(k, dtype=torch.float32, device=dev) * (2.0 * math.pi / k)
    Rz = torch.zeros((k, 3, 3), dtype=torch.float32, device=dev)
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1] = torch.cos(ang), -torch.sin(ang), torch.sin(ang), torch.cos(ang)
    Rz[:, 2, 2] = 1.0
    shift = ct - cs                                                      # (L, 3)
    trans = (ct - (Rz @ ct[:, None])[..., 0]) + (Rz @ shift[:, None, :, None])[..., 0]   # (L, k, 3)
    T = make_T(Rz.expand(trans.shape[:-1] + (3, 3)), trans)              # (L, k, 4, 4)
    L, N = src.shape[:2]
    s = torch.where(smask[..., None], src, torch.full_like(src, SENTINEL))[:, None].expand(L, k, N, 3)
    gm = smask[:, None].expand(L, k, N)
    done = torch.zeros((L, k), dtype=torch.bool, device=dev)
    for _ in range(cfg["icp_max_iterations"]):
        st = transform(T, s, prec)
        idx, _ = nearest(st, tpts, prec)
        wt = gm.to(torch.float32) * huber_weight(((tnrm[idx]) * (st - tpts[idx])).sum(-1), 0.02)
        T_new, xi = gn_step(T, st, tpts[idx], tnrm[idx], wt, 1e-6, prec)
        T = torch.where(done[..., None, None], T, T_new)
        done = done | ((xi * xi).sum(-1) < 1e-12)
    st = transform(T, s, prec)
    _, d2 = nearest(st, tpts, prec)
    g = gm.to(torch.float32)
    fit = (d2 * g).sum(-1) / torch.clamp(g.sum(-1), min=1.0)
    return inverse(T), fit


def run(depths: torch.Tensor, indices: torch.Tensor, camera: dict, cfg: dict,
        template: np.ndarray, dims, prec: Precision = Precision(), lanes: int = 16,
        icp_ulp: bool = False):
    """Reference results of frames (F, H, W) with triplets (F, K, 3) and
    the template's points (N, 3) of a ``dims`` cuboid: a dict of numpy
    arrays pose (F, 4, 4), fitness, accepted, plane (F, 4), plane_valid,
    bbox (F, 8, 3), num_box_points, and each ICP restart's fitness (F, k)
    and box (F, k, 8, 3). ``icp_ulp`` moves every box point one float32
    ulp up before ICP (a rounding baseline of the ICP stage alone)."""
    with full_float32():
        return _run(depths, indices, camera, cfg, template, dims, prec, lanes, icp_ulp)


def _run(depths, indices, camera, cfg, template, dims, prec, lanes, icp_ulp):
    dev = depths.device
    tp, tn = template_features(template, cfg)
    tpts, tnrm = torch.from_numpy(tp).to(dev), torch.from_numpy(tn).to(dev)
    s = cfg["depth_stride"]
    o = s // 2
    f32 = np.float32
    fx, fy = f32(camera["fx"]) / f32(s), f32(camera["fy"]) / f32(s)
    cx, cy = (f32(camera["cx"]) - f32(o)) / f32(s), (f32(camera["cy"]) - f32(o)) / f32(s)
    radius = 0.5 * float(np.linalg.norm(dims)) + 0.02 if cfg["blob_radius"] is None else cfg["blob_radius"]
    out = {k: [] for k in ("plane", "plane_valid", "num_box_points")}
    boxes, bmasks = [], []
    for f in range(depths.shape[0]):
        z = depths[f, o::s, o::s]
        h, w = z.shape
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        valid = torch.isfinite(z) & (z > 0.05) & (z < 10.0)
        z = torch.where(valid, z, torch.zeros_like(z))
        pts = torch.stack([(u - torch.tensor(cx, device=dev)) / torch.tensor(fx, device=dev) * z,
                           (v - torch.tensor(cy, device=dev)) / torch.tensor(fy, device=dev) * z, z], -1).reshape(-1, 3)
        m = _keep(valid.reshape(-1) & _passthrough(pts, cfg), cfg["pre_capacity"])
        cents = _voxel_centroids(pts[m], cfg["voxel_size"])
        n = cents.shape[0]
        kept = min(n, cfg["work_capacity"])
        r = torch.arange(kept, device=dev)
        work, wm = _pad(cents[(r * n) // max(kept, 1)], cfg["work_capacity"])
        plane, inl, pvalid = _ransac(work, wm, indices[f].to(dev).long(), cfg["ransac_threshold"], prec)
        bm = _keep(wm & ~inl, cfg["box_capacity"])
        box, bmask = _pad(work[bm], cfg["box_capacity"])
        if cfg["cluster_filter"] == "blob":
            bmask = _blob(box, bmask, radius)
        elif cfg["cluster_filter"] != "off":
            raise ValueError(f"the reference has no cluster filter {cfg['cluster_filter']!r}")
        boxes.append(torch.where(bmask[:, None], box, torch.full_like(box, SENTINEL)))
        bmasks.append(bmask)
        out["plane"].append(plane)
        out["plane_valid"].append(pvalid)
        out["num_box_points"].append(int(bmask.sum()))
    boxes, bmasks = torch.stack(boxes), torch.stack(bmasks)
    if icp_ulp:
        boxes = torch.where(bmasks[..., None], torch.nextafter(boxes, torch.full_like(boxes, float("inf"))), boxes)
    poses, fits = [], []
    for a in range(0, boxes.shape[0], lanes):
        p, fi = _icp(boxes[a:a + lanes], bmasks[a:a + lanes], tpts, tnrm, cfg, prec)
        poses.append(p)
        fits.append(fi)
    all_pose, all_fit = torch.cat(poses), torch.cat(fits)
    rows = torch.arange(all_fit.shape[0], device=dev)
    best = torch.argmin(all_fit, dim=-1)  # the first of equal fitnesses
    pose, fitness = all_pose[rows, best], all_fit[rows, best]
    L, W, H = dims
    corners = torch.tensor([[sx * L / 2, sy * W / 2, sz * H / 2] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], dtype=torch.float32, device=dev)
    bbox = transform(pose, corners.expand(pose.shape[0], 8, 3), prec)
    restart_bbox = transform(all_pose, corners.expand(all_pose.shape[:2] + (8, 3)), prec)
    nbox = np.array(out["num_box_points"], np.int64)
    pvalid = np.array(out["plane_valid"], bool)
    fit = fitness.cpu().numpy()
    return {
        "pose": pose.cpu().numpy(), "fitness": fit,
        "accepted": (fit < cfg["fitness_threshold"]) & pvalid & (nbox >= 50),
        "plane": torch.stack(out["plane"]).cpu().numpy(), "plane_valid": pvalid,
        "bbox": bbox.cpu().numpy(), "num_box_points": nbox,
        "restart_fitness": all_fit.cpu().numpy(), "restart_bbox": restart_bbox.cpu().numpy(),
    }
