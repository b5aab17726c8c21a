"""BENCHMARK.json's entries resolve to their files, keep to the contract's
forms, and nothing the benchmark loads is JAX or the JAX package."""

import json
import re
import subprocess
import sys

import pytest

from small_cells import ROOT
from perfbench import harness

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_forms():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in MANIFEST[g]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves(cell):
    manifest, entry, config, traffic = harness.cell_spec(cell)
    assert (ROOT / "perfbench" / "systems" / f"{config['system']}.py").is_file()
    assert set(config["limits"]) and traffic
    e2e = harness.metrics_of(manifest, cell, False)
    layer = harness.metrics_of(manifest, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))
        if m in layer:
            assert any(m["moves"] == e["name"] for e in e2e)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, the systems and a small CPU run of each cell load no
    module whose top-level name is jax, jaxlib, flax or perception_tpu
    (perception_tpu_torch is another name)."""
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'perfbench/tests')\n"
        "import small_cells\n"
        "from perfbench import harness, control\n"
        "for cell, edit in small_cells.SMALL.items():\n"
        "    harness.run_cell(cell, 5, 0.5, False, time.perf_counter(), device=torch.device('cpu'), edit=edit)\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = _loaded(code)
    assert "perception_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "perception_tpu", "benchmarks"}


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "import perfbench.reference.cuboid, perfbench.reference.odometry, perfbench.reference.common\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    top = _loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "perception_tpu", "perception_tpu_torch", "benchmarks"}
