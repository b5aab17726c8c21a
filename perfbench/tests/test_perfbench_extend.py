"""A configuration, a traffic mix and a per-layer metric are added as new
files only, and the harness finds them by name."""

import json
import shutil
import time

import torch

from small_cells import ROOT, SMALL, CUBOID
from perfbench import harness


def test_new_config_cell_and_metric_as_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/cuboid_d435.json").read_text())
    cfg["settings"]["icp_restarts"] = 2
    (tmp_path / "perfbench/configs/cuboid_d435_r2.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "perfbench/workloads/cuboid.replay_b64.json").read_text())
    traffic["batch"] = 3
    (tmp_path / "perfbench/workloads/cuboid_r2.replay_b3.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench/metrics/frames_per_call.py").write_text(
        "def read(ctx):\n    return ctx.traffic['batch']\n")
    manifest["configs"].append({"name": "cuboid_d435_r2", "source": "a test", "reduced": ["icp_restarts"],
                                "file": "perfbench/configs/cuboid_d435_r2.json", "why": "a test"})
    manifest["workloads"].append({"name": "cuboid_r2.replay_b3", "config": "cuboid_d435_r2",
                                  "traffic": "replay_b3", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "frames_per_call", "unit": "frames", "better": "higher",
                                  "source": "program_counter", "layer": "a test", "moves": "cuboid_fps",
                                  "workloads": ["cuboid_r2.replay_b3"]})
    manifest["end_to_end"][0]["workloads"].append("cuboid_r2.replay_b3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    def edit(config, traffic):
        assert config["settings"]["icp_restarts"] == 2 and traffic["batch"] == 3
        SMALL[CUBOID](config, traffic)
        traffic["batch"] = 3

    r, _, _ = harness.run_cell("cuboid_r2.replay_b3", 7, 0.5, True, time.perf_counter(),
                               device=torch.device("cpu"), root=tmp_path, edit=edit)
    assert r["correct"] and r["metrics"]["frames_per_call"]["value"] == 3
    r, _, _ = harness.run_cell("cuboid_r2.replay_b3", 7, 0.5, False, time.perf_counter(),
                               device=torch.device("cpu"), root=tmp_path, edit=edit)
    assert set(r["metrics"]) == {"cuboid_fps", "setup_s"}
