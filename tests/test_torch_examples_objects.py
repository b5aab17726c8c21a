"""The port's detection-service examples (``examples_torch/`` 02 and 09)
on the CPU, each run as a script through ``runpy`` with
``PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu`` and held to its own asserts
(the JAX examples' thresholds): 02's service answers success on the
eraser-sized box, 09 recovers at least 3 of its 4 clutter classes within
1.5 cm. A file of their own, as they are the slowest of the geometry
examples on the CPU.
"""

import pytest

from test_torch_examples_geometry import run_example

EXAMPLES = ["02_multi_object_service", "09_cluttered_scene_with_gt_protocol"]


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_runs_on_the_cpu(stem):
    run_example(stem)
