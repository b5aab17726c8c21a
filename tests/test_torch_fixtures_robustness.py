"""``tools_torch/fixtures_robustness.py`` and the JAX key streams it (and the
examples) draw from, against the JAX package on the CPU.

The port's held-out tables at the JAX tool's sizes, formatted as
FIXTURES.md formats them, equal the committed FIXTURES.md (the JAX tool's
run) row for row. The draws: ``jax_random.randint`` bit-exact;
``sample_skeletons_from_key`` and ``sample_hand_from_key`` within 1e-4 px
(their rotations' cos/sin may round another way than XLA's), validity
equal; ``sample_face_at_from_key`` within 1e-4 px; ``init_posenet`` from a
key within 1e-6 of ``init_posenet(key)``; the hand fixture's evaluation
from a key within 1e-4 px of the JAX ``evaluate(params, key)``, with and
without pixel noise.
"""

import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from perception_tpu_torch.utils import jax_random as jr

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed,shape,lo,hi", [(0, (5, 7), 0, 256), (3, (), 1, 3), (2, (2, 128), 0, 256),
                                              (9, (1000,), -50, 100000), (4, (3,), 5, 5)])
def test_randint_equals_jax(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
    got = jr.randint(jr.key(seed), shape, lo, hi)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_skeleton_and_hand_draws_equal_jax(seed):
    from perception_tpu.models import hand_data as jhand
    from perception_tpu.models import pose_data as jpose
    from perception_tpu_torch.models import hand_data, pose_data

    want = jpose.sample_skeletons(jax.random.key(seed), (128, 128), n_people=4, scale_range=(0.3, 0.9))
    got = pose_data.sample_skeletons_from_key(jr.key(seed), (128, 128), n_people=4, scale_range=(0.3, 0.9))
    assert np.abs(got.joints - np.asarray(want.joints)).max() <= 1e-4
    assert np.array_equal(got.valid, np.asarray(want.valid))
    hw = jhand.sample_hand(jax.random.key(seed), (96, 96))
    hp = hand_data.sample_hand_from_key(jr.key(seed), (96, 96))
    assert np.abs(hp.joints - np.asarray(hw.joints)).max() <= 1e-4 and float(hp.scale) == float(hw.scale)


def test_face_placement_and_posenet_init_equal_jax():
    from perception_tpu.models import face_data as jface
    from perception_tpu.models.pose import init_posenet as jinit
    from perception_tpu_torch.convert import posenet_to_flax
    from perception_tpu_torch.models import face_data
    from perception_tpu_torch.models.pose import init_posenet

    for i in range(3):
        want = jface.sample_face_at(jax.random.fold_in(jax.random.key(5), i), (256, 256), 300.0, 300.0,
                                    (0.14, -0.14), 0.62)
        got = face_data.sample_face_at_from_key(jr.fold_in(jr.key(5), i), (256, 256), 300.0, 300.0,
                                                (0.14, -0.14), 0.62)
        assert np.abs(got.landmarks2d - np.asarray(want.landmarks2d)).max() <= 1e-4
        assert float(got.au02) == float(want.au02)
    want = jax.tree_util.tree_leaves(jinit(jax.random.key(0), "COCO_18", net_hw=(32, 32))["params"])
    got = jax.tree_util.tree_leaves(posenet_to_flax(init_posenet(jr.key(0), "COCO_18", device="cpu"))["params"])
    assert len(got) == len(want) and max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                                         for a, b in zip(got, want)) <= 1e-6


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_hand_evaluation_from_a_key_equals_jax(noise):
    from perception_tpu.models import hand_fixture as jhf
    from perception_tpu_torch.models import hand_fixture

    want = jhf.evaluate(jhf.load_fixture(), jax.random.key(3), n_scenes=4, pixel_noise=noise)
    got = hand_fixture.evaluate(hand_fixture.load_fixture("cpu"), jr.key(3), n_scenes=4, pixel_noise=noise,
                                device="cpu")
    assert abs(got - want) <= 1e-4


def test_robustness_tables_equal_the_committed_fixtures_md(tmp_path):
    tool = runpy.run_path(str(ROOT / "tools_torch" / "fixtures_robustness.py"))
    out = tmp_path / "FIXTURES.md"
    with torch.no_grad():
        assert tool["main"](["--cpu", "--out", str(out)]) == 0
    rows = [l for l in out.read_text().splitlines() if l.startswith("| ")]
    committed = [l for l in (ROOT / "FIXTURES.md").read_text().splitlines() if l.startswith("| ")]
    assert len(rows) == 9 + 6 + 4 + 3
    assert rows == committed
