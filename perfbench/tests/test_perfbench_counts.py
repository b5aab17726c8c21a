"""The frozen counts and bounds agree with chip_smoke.py's at the shapes of
PERF.md's kernel table."""

import pytest
import torch

import chip_smoke
from perfbench.counts import k1, k2, peaks


@pytest.mark.parametrize("b, n, k, bound_us", [(1, 8192, 1024, 1.13), (8, 8192, 1024, 9.01),
                                               (1, 32768, 1024, 4.51), (1, 8192, 512, 0.563),
                                               (64, 8192, 1024, None)])
def test_k1_counts(b, n, k, bound_us):
    pts, mask, hyp = torch.zeros(b, n, 3), torch.zeros(b, n, dtype=torch.bool), torch.zeros(b, k, 4)
    theirs = chip_smoke.bound(9 * b * n * k, chip_smoke.nbytes(pts, mask, hyp) + 4 * b * k)
    mine = peaks.bound_s(k1.ops(b, n, k), k1.nbytes(b, n, k))
    assert mine[1] == theirs[1] == "operations"
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)
    if bound_us is not None:
        assert round(mine[0] * 1e6, 3 if bound_us < 1 else 2) == bound_us


@pytest.mark.parametrize("n, m, bound_us", [(4096, 8192, 5.02), (2048, 4096, 1.26), (8192, 32768, 40.08)])
def test_k2_counts(n, m, bound_us):
    args = chip_smoke.k2_inputs(1, n, m, False, "cpu", seed=1)
    R, Np, Mp = args[0].shape[0], args[0].shape[1], args[1].shape[0]
    assert (Np, Mp) == k2.padded(n, m)
    theirs = chip_smoke.bound(R * Np * (10 * Mp + 130), chip_smoke.nbytes(*args) + 4 * R * 66)
    mine = peaks.bound_s(k2.ops(R, Np, Mp), k2.nbytes(R, Np, Mp))
    assert mine[1] == theirs[1] == "operations"
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)
    assert round(mine[0] * 1e6, 2) == bound_us


def test_peaks_match_the_port():
    from perception_tpu_torch.utils import roofline

    assert (peaks.F32_FLOPS, peaks.HBM_BYTES) == (chip_smoke.PEAK_F32_OPS, chip_smoke.PEAK_BYTES)
    f32, bf16, hbm = roofline._PEAKS["H100 80GB HBM3"]
    assert (peaks.F32_FLOPS, peaks.BF16_FLOPS, peaks.HBM_BYTES) == (f32 * 1e12, bf16 * 1e12, hbm * 1e9)
