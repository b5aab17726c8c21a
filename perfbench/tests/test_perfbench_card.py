"""On the card: each cell's command runs, prints a correct result with
every metric, and its traced run reads the per-layer metrics. Skipped
without a CUDA card (run these on the chip)."""

import json
import subprocess
import sys

import pytest

from small_cells import ROOT, SEED
from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cuda_device, cell, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(SEED),
                          "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.metrics_of(manifest, cell, bool(trace))}
    assert r["correct"] and set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(m["value"] <= 105 for k, m in r["metrics"].items() if k.endswith("_roofline_pct"))
