"""K3+K4, the voxel-hash range query (``csrc/voxelhash_query.cu``), one
launch of its two kernels (scan, merge).

Counted as the work any exact search over the hash must do, whatever
implements it: the (query, map point) pairs whose map point lies in one
of the query's 27 neighbouring cells of side ``cell`` (the search
radius, the hash's cell size), 8 float32 operations a pair (3
differences, 3 squares, 2 adds). Bytes: the table (rows, 8) float32 read
once, 12 B in (a query's x, y, z) and 8 B out (its index and squared
distance) a query. The pairs depend on the data, so the cell gives the
mean over a sample of its launches (``pairs``).
"""

from __future__ import annotations

import itertools

import numpy as np

KERNELS = ("voxelhash_scan_kernel", "voxelhash_merge_kernel")
LAUNCH_KERNEL = "voxelhash_merge_kernel"  # one per launch

_HALF = 1 << 19  # cell coordinates are kept within +-_HALF, 20 bits an axis in a key


def ops(pairs: float, queries: int, rows: int) -> float:
    return 8 * pairs


def nbytes(pairs: float, queries: int, rows: int) -> int:
    return 32 * rows + 20 * queries


def _keys(cells: np.ndarray) -> np.ndarray:
    c = np.clip(cells, -_HALF + 1, _HALF - 2) + _HALF
    return (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]


def pairs(queries: np.ndarray, points: np.ndarray, cell: float, origin=None) -> int:
    """The (query, point) pairs whose point lies in one of the query's 27
    neighbouring cells: ``queries`` (Nq, 3) and ``points`` (M, 3), valid
    rows alone; cells of side ``cell`` on a grid through ``origin``
    (default: one cell below the points' lower corner, as the hash fits
    its grid)."""
    queries, points = np.asarray(queries, np.float64), np.asarray(points, np.float64)
    if not len(queries) or not len(points):
        return 0
    if origin is None:
        origin = points.min(0) - cell
    cp = np.floor((points - origin) / cell).astype(np.int64)
    cq = np.floor((queries - origin) / cell).astype(np.int64)
    keys, counts = np.unique(_keys(cp), return_counts=True)
    total = 0
    for d in itertools.product((-1, 0, 1), repeat=3):
        k = _keys(cq + np.array(d, np.int64))
        at = np.clip(np.searchsorted(keys, k), 0, len(keys) - 1)
        total += int(np.where(keys[at] == k, counts[at], 0).sum())
    return total
