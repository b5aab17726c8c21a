"""The cells' comparison on the CPU at a small size: the port agrees with
the plain reference; the control (the reference with TF32 operands in
the port's place) and planted faults come out not correct."""

import time

import pytest
import torch

from small_cells import CUBOID, ODOM, SEED, SMALL
from perfbench import control, harness

CPU = torch.device("cpu")


def run(cell, seed=SEED):
    return harness.run_cell(cell, seed, 1.0, False, time.perf_counter(), device=CPU, edit=SMALL[cell])[0]


@pytest.mark.parametrize("cell", [CUBOID, ODOM])
def test_port_agrees_with_reference(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", [CUBOID, ODOM])
def test_control_fails(cell):
    r = control.readings(cell, 3, 1.0, CPU, edit=SMALL[cell])
    _, _, config, _ = harness.cell_spec(cell)
    limits = config["limits"]
    assert set(r["program"]) == set(r["control"]) == set(limits)
    assert all(r["program"][k] <= limits[k] for k in limits)
    assert any(r["control"][k] > limits[k] for k in limits)


def _patch_cuboid(monkeypatch, fault):
    from perception_tpu_torch.models import cuboid

    real = cuboid.cuboid_pipeline_batch

    def broken(depths, *a, **k):
        if fault == "half":  # half of the batch left out, the rest's results in its place
            idx = k["indices"]
            res = real(depths[: len(depths) // 2].repeat(2, 1, 1), *a, **dict(k, indices=idx[: len(idx) // 2].repeat(2, 1, 1)))
            return res
        res = real(depths, *a, **k)
        return res._replace(pose=res.pose + 0.01, bbox=res.bbox + 0.01)  # an answer altered

    monkeypatch.setattr(cuboid, "cuboid_pipeline_batch", broken)


def _patch_odom(monkeypatch, fault):
    from perception_tpu_torch.models.slam import odometry

    real = odometry.odometry_step

    def broken(state, *a, **k):
        new, diag = real(state, *a, **k)
        if fault == "unchanged":  # the step returns its state unchanged
            return state, diag
        pose = new.pose.clone()
        pose[0, 3] += 1e-3  # an answer altered
        return new._replace(pose=pose), diag

    monkeypatch.setattr(odometry, "odometry_step", broken)


@pytest.mark.parametrize("cell, fault", [(CUBOID, "half"), (CUBOID, "altered"),
                                         (ODOM, "unchanged"), (ODOM, "altered")])
def test_faults_come_out_not_correct(monkeypatch, cell, fault):
    (_patch_cuboid if cell == CUBOID else _patch_odom)(monkeypatch, fault)
    r = run(cell)
    assert not r["correct"] and r["failed"] == 0
