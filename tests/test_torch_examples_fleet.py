"""The port's multi-process and streaming examples (``examples_torch/``
07, 12, 13) on the CPU, each run as a script through ``runpy`` with
``PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu`` and held to its own asserts
(the JAX examples' thresholds): 07's (dp=1, sp=2) fleet of 2 gloo ranks
(max pose error under 5e-3), 12's ten tracker frames (every object
latched, the last frame's errors under 4 cm), 13's three-face facade
(3 faces on each of 4 frames) and its 2-rank fleet (ICP sharded against
single within 1e-4 and the truth within 0.01, BA within 0.05 with its cost
cut tenfold, checked inside each rank). Example 07 is also run at 4 ranks
(dp=2, sp=2), the card's layout.
"""

from pathlib import Path

import pytest

from test_torch_examples_geometry import run_example

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["07_multichip_sharding", "12_multi_object_tracking", "13_multi_face_and_multihost"]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE", "cpu")


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_runs_on_the_cpu(stem):
    run_example(stem)


def test_example_07_on_four_ranks(on_cpu):
    from examples_torch._common import load

    got = load("07_multichip_sharding").main(ranks=4)
    assert (got["dp"], got["sp"]) == (2, 2) and got["transforms"].shape == (4, 4, 4)
    assert got["max_pose_error"] < 5e-3
