"""Trajectory accuracy: ATE with Umeyama alignment (TUM definitions).

A numpy copy of ``perception_tpu/utils/metrics.py``'s ``ate`` and
``align_umeyama``, so the port needs no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    alignment: np.ndarray  # (4, 4) estimate -> ground-truth frame


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) transform src->dst
    over (N, 3) position sets."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    H = sc.T @ dc / len(src)
    U, S, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    if with_scale:
        var_s = (sc**2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def ate(estimated: np.ndarray, ground_truth: np.ndarray, align: bool = True) -> ATEResult:
    """ATE over (N, 4, 4) pose arrays (matched frame-by-frame)."""
    est_p = estimated[:, :3, 3]
    gt_p = ground_truth[:, :3, 3]
    T = align_umeyama(est_p, gt_p) if align else np.eye(4)
    est_aligned = est_p @ T[:3, :3].T + T[:3, 3]
    err = np.linalg.norm(est_aligned - gt_p, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        alignment=T,
    )
