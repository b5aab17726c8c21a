"""The port's multi-process runtime (``perception_tpu_torch/parallel/
{multihost, dryrun, scaling}.py``) on gloo fleets on the CPU: the dry run
at the tests' shapes with 2 ranks (every step's OK line; the replicated
outputs bit-identical on both ranks, which the dry run checks inside the
fleet), a rank that fails or disagrees failing its caller, fleets that
default to the card refusing to start without one, and the scaling
harness at 1 and 2 ranks (``tests/test_scaling.py``'s bounds).
"""

import numpy as np
import pytest
import torch

from perception_tpu_torch.parallel import dryrun
from perception_tpu_torch.parallel.multihost import run_fleet
from perception_tpu_torch.parallel.scaling import measure_scaling

import torch_fleet_cases


def test_dryrun_small_on_two_ranks(capsys):
    got = dryrun.run(2, "gloo", "cpu", small=True)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("dryrun ") and " ok: " in l]
    assert [l.split()[1] for l in lines] == [name for name, _ in dryrun.STEPS]
    assert all("R=2 gloo/cpu" in l and "bit-identical on 2 ranks" in l for l in lines)
    # Every step was held to its single-rank run.
    assert all("not run" not in l for l in lines)
    out = {name: got[name][0] for name, _ in dryrun.STEPS}
    assert out["icp"]["transforms"].shape == (1, 4, 4) and out["map_odometry"]["transforms"].shape == (4, 4, 4)
    assert np.isfinite(out["train"]["loss"]) and out["pose_graph"]["c1"] < out["pose_graph"]["c0"]
    assert out["ba"]["final_cost"] < out["ba"]["initial_cost"]


def test_dryrun_without_a_card_stops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--ranks", "1", "--backend", "nccl", "--device", "cuda"]) == 1


@pytest.mark.parametrize("case,match", [("failing_case", "rank 1 fails on purpose"),
                                        ("mismatch_case", "differs between rank 0 and rank 1")])
def test_a_failing_rank_fails_the_fleet(case, match):
    with pytest.raises(RuntimeError, match=match):
        run_fleet(getattr(torch_fleet_cases, case), 2, (None,), device="cpu", timeout_s=60)


def test_fleets_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_fleet(torch_fleet_cases.failing_case, 2, (None,))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        measure_scaling([1], frames_per_device=1, points=64, map_points=64, iterations=1, reps=1)


def test_scaling_harness_runs():
    res = measure_scaling([1, 2], frames_per_device=2, points=256, map_points=512, iterations=2, reps=2,
                          device="cpu")
    assert 1 in res and 2 in res
    assert res[1]["frames_per_sec"] > 0
    assert res[2]["batch"] == 4
    assert "efficiency" in res[2]
    # Ranks sharing one host's cores: efficiency is structural only.
    assert res[2]["efficiency"] > 0.1
