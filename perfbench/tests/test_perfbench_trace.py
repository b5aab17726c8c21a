"""The trace arithmetic on synthetic device intervals."""

from types import SimpleNamespace

import pytest

from perfbench import readers, trace
from perfbench.counts import k1, k2, peaks
from perfbench.systems.record import Window

Op = trace.DeviceOp


def test_union_merges_overlaps_and_nesting():
    ops = [Op("a", 0.0, 1.0), Op("b", 0.5, 1.5), Op("c", 0.6, 0.7), Op("d", 2.0, 2.5), Op("e", 2.5, 3.0)]
    assert trace.union_s(ops) == pytest.approx(2.5)
    assert trace.union_s([]) == 0.0


def test_gaps_name_the_operation_before():
    ops = [Op("a", 1.0, 2.0), Op("b", 1.5, 2.5), Op("c", 4.0, 5.0)]
    g = trace.gaps(ops, 0.0, 6.0)
    assert g == [(0.0, 1.0, "window start"), (2.5, 4.0, "b"), (5.0, 6.0, "c")]
    assert sum(b - a for a, b, _ in g) + trace.union_s(ops) == pytest.approx(6.0)


def test_clip_keeps_ops_that_start_inside():
    ops = [Op("a", -1.0, 0.5), Op("b", 0.2, 0.4), Op("c", 0.9, 1.5), Op("d", 1.0, 1.2)]
    assert trace.clip(ops, 0.0, 1.0) == [Op("b", 0.2, 0.4), Op("c", 0.9, 1.0)]


def test_phase_at():
    spans = [(0.0, 1.0, "call"), (1.0, 1.5, "read")]
    assert [trace.phase_at(spans, t) for t in (0.5, 1.2, 2.0)] == ["call", "read", "harness"]


def _ctx(ops, shapes, units=10, seconds=2.0):
    return SimpleNamespace(ops=ops, kernel_shapes=shapes, window=Window(start=0.0, end=seconds, units=units))


def test_idle_and_launches():
    ctx = _ctx([Op("x", 0.0, 0.5), Op("y", 1.0, 1.5)], {})
    assert readers.idle_pct(ctx) == pytest.approx(50.0)
    assert readers.launches_per_unit(ctx) == pytest.approx(0.2)
    assert readers.idle_pct(_ctx(None, {})) is None


def test_k1_roofline_by_kernel_name():
    shape = (64, 8192, 1024)
    least, what = peaks.bound_s(k1.ops(*shape), k1.nbytes(*shape))
    assert what == "operations"
    t = least / 0.4  # each launch at 40% of its bound
    ops = [Op("ransac_score_kernel", i, i + t) for i in range(3)] + [Op("other", 5.0, 6.0)]
    assert readers.roofline_pct(_ctx(ops, {"k1": shape}), k1, "k1") == pytest.approx(40.0)
    assert readers.roofline_pct(_ctx([Op("other", 0, 1)], {"k1": shape}), k1, "k1") is None


def test_k2_roofline_sums_its_three_kernels():
    shape = (1,) + k2.padded(8192, 32768)
    least, _ = peaks.bound_s(k2.ops(*shape), k2.nbytes(*shape))
    ops = []
    for i in range(4):  # a launch: NN 70%, system 20%, finish 10% of 2x the bound
        t = 2 * least
        ops += [Op("icp_gn_nn_kernel", i, i + 0.7 * t), Op("icp_gn_system_kernel", i + 0.7 * t, i + 0.9 * t),
                Op("icp_gn_finish_kernel", i + 0.9 * t, i + t)]
    assert readers.roofline_pct(_ctx(ops, {"k2": shape}), k2, "k2") == pytest.approx(50.0)
