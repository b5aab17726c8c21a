"""The port's voxel hash (``ops/voxelhash.py``, kernel K3+K4) against the
JAX package.

On the CPU the query kernel's wrapper takes its plain version, which
mirrors the JAX package's CPU path (``_query_kernel_xla``). Tolerances:
the build (sorted points, ids, order, grid) and the tile ranges are
exact; query d2 agrees within 2 float32 ulps (XLA may fuse the squares'
adds into FMAs) and the indices are equal except where two candidates'
d2 lie within that margin (a rounding tie). Checked below and above the
49152-row table size at which the range alignment changes from 8 to 128
rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from perception_tpu.ops import voxelhash as jvh
from perception_tpu_torch.ops import voxelhash as vh
from perception_tpu_torch.ops.kernels import voxelhash_query as vq

torch.set_num_threads(2)


def cloud(seed, m, nq, noise=0.01, frac=1.0):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    mask = rng.rand(m) < frac
    q = (ref[rng.randint(0, m, nq)] + rng.randn(nq, 3) * noise).astype(np.float32)
    return ref, mask, q


def builds(ref, mask, cell):
    return (vh.build(torch.from_numpy(ref), torch.from_numpy(mask), cell),
            jvh.build(jnp.asarray(ref), jnp.asarray(mask), cell))


def assert_same_nn(got, want, hash_points):
    """Indices equal except on rounding ties; d2 within 2 ulps."""
    gi, gd = (t.numpy() for t in got[:2])
    wi, wd = (np.asarray(a) for a in want[:2])
    np.testing.assert_allclose(gd, wd, rtol=2.4e-7, atol=1e-12)
    diff = gi != wi
    if diff.any():
        # Both picks must be equally near (to the tolerance above).
        assert diff.mean() < 1e-3, diff.sum()
        np.testing.assert_allclose(gd[diff], wd[diff], rtol=2.4e-7)
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("m,frac", [(20000, 1.0), (6000, 0.7)])
def test_build_matches_jax(m, frac):
    ref, mask, _ = cloud(0, m, 1, frac=frac)
    t, j = builds(ref, mask, 0.05)
    for name in ("points", "table", "cell_ids", "order", "origin", "dims", "sentinel_id"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    assert float(t.cell_size) == float(j.cell_size)


@pytest.mark.parametrize(
    "m,nq,cell,sort",
    [
        (20000, 2000, 0.05, True),    # table 21504 rows: 8-row range alignment
        (52000, 3000, 0.06, True),    # table 53248 rows: 128-row alignment
        (20000, 700, 0.05, False),    # the caller's (incoherent) order: tiles overflow
    ],
)
def test_query_matches_jax_below_and_above_49152_rows(m, nq, cell, sort):
    ref, mask, q = cloud(1, m, nq)
    t, j = builds(ref, mask, cell)
    assert (t.table.shape[0] > 49152) == (m > 49152 - 1024)
    got = vh.query(t, torch.from_numpy(q), sort=sort, return_stats=True)
    want = jvh.query(j, jnp.asarray(q), sort=sort, return_stats=True)
    assert_same_nn(got, want, t.points)
    assert float(got[2]) == float(want[2])
    assert sort or float(got[2]) > 0.5
    if sort:
        od, oi = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64))
        in_r = od <= cell
        assert np.mean(t.order.numpy()[got[0].numpy()][in_r] == oi[in_r]) >= 0.999


def test_tile_ranges_equal_jax():
    ref, mask, q = cloud(2, 8000, 600)
    t, j = builds(ref, mask, 0.05)
    qs, order = vh.sort_by_cell(t, torch.from_numpy(q))
    jqs, jorder = jvh.sort_by_cell(j, jnp.asarray(q))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    q_pad = torch.cat([qs, torch.full((40, 3), 1.0e6)])
    for align in (8, 128):
        got = vh._tile_ranges(t, q_pad, 600, 128, 4096, 512, align=align)
        want = jvh._tile_ranges(j, jnp.asarray(q_pad.numpy()), 600, 128, 4096, 512, align=align)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_presorted_warm_path_matches_sorted_query():
    ref, mask, q = cloud(3, 8000, 500, noise=0.005)
    t, _ = builds(ref, mask, 0.05)
    qs, order = vh.sort_by_cell(t, torch.from_numpy(q))
    wi, wd = vh.query(t, qs, sort=False)
    ci, cd = vh.query(t, torch.from_numpy(q))
    assert torch.equal(wi, ci[order]) and torch.equal(wd, cd[order])


def test_all_false_mask_finds_nothing():
    ref, _, q = cloud(4, 3000, 300)
    mask = np.zeros(3000, bool)
    t, j = builds(ref, mask, 0.05)
    got = vh.query(t, torch.from_numpy(q))
    want = jvh.query(j, jnp.asarray(q))
    assert_same_nn(got, want, t.points)
    assert float(got[1].min()) > 1e11  # every candidate is a parked row


def test_one_shot_misses_and_mask():
    _, d2, found = vh.nearest_neighbor_voxelhash(
        torch.tensor([[1.0, 1.0, 1.0]]), torch.zeros(1, 3), torch.ones(1, dtype=torch.bool), 0.1)
    assert not bool(found[0])
    nbr, _, found = vh.nearest_neighbor_voxelhash(
        torch.zeros(1, 3), torch.tensor([[0.0, 0, 0], [0.01, 0, 0]]), torch.tensor([False, True]), 0.05)
    assert bool(found[0])
    np.testing.assert_allclose(nbr[0].numpy(), [0.01, 0, 0], atol=1e-6)


def test_reference_grouping_is_invisible(monkeypatch):
    ref, mask, q = cloud(5, 6000, 900)
    t, _ = builds(ref, mask, 0.05)
    want = vh.query(t, torch.from_numpy(q), tile=128)
    monkeypatch.setattr(vq, "_REF_ELEMS", 1)  # one tile per group
    got = vh.query(t, torch.from_numpy(q), tile=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_dispatch_counts_no_launch():
    ref, mask, q = cloud(6, 2000, 100)
    t, _ = builds(ref, mask, 0.05)
    before = vq.voxelhash_query.launches
    vh.query(t, torch.from_numpy(q))
    assert vq.voxelhash_query.launches == before
