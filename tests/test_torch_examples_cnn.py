"""The port's CNN examples (``examples_torch/`` 03, 04, 06, 11) on the
CPU, each run as a script through ``runpy`` with
``PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu`` and held to its own asserts
(the JAX examples' thresholds). Example 06's loss curve is held to the JAX
example's computation from the same ``key(0)`` weights and ``key(1)``
batch: each of the five losses within 1e-3 relative (the weights agree
but for a few ulps, the convolutions sum in another order, and Adam
carries the difference through five steps of a curve that jumps from 0.06
to 0.13 and back). Example 03's PCK and recall on the JAX example's
``key(7)`` scenes, and example 11's three faces (gates equal, landmarks
within 1e-3 px), are held to the JAX example's numbers on the same draws.
"""

from pathlib import Path

import numpy as np
import pytest

from test_torch_examples_geometry import run_example

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["03_pose_keypoints_from_image", "04_face_head_pose_and_gaze", "06_training_and_checkpoints",
            "11_trained_face_pipeline"]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE", "cpu")


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_runs_on_the_cpu(stem):
    run_example(stem)


def jax_example_06_losses():
    """The JAX example 06's five losses (its computation, without the print)."""
    import jax
    import jax.numpy as jnp

    from perception_tpu.models.pose import TOPOLOGIES, PoseNet, init_posenet
    from perception_tpu.models.train import init_train_state, make_optimizer, make_train_step

    parts, pairs = TOPOLOGIES["MPI_15"]
    net = PoseNet(num_parts=len(parts), num_limbs=len(pairs))
    params = init_posenet(jax.random.key(0), "MPI_15", net_hw=(32, 32))
    optimizer = make_optimizer(learning_rate=1e-3, kind="adam")
    step = make_train_step(net.apply, optimizer)
    state = init_train_state(params, optimizer)
    batch = {
        "image": jax.random.uniform(jax.random.key(1), (2, 32, 32, 3)),
        "paf": jnp.zeros((2, 4, 4, 2 * len(pairs))),
        "heatmap": jnp.zeros((2, 4, 4, len(parts) + 1)).at[..., -1].set(1.0),
    }
    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses


def test_example_06_loss_curve_equals_jax(on_cpu):
    from examples_torch._common import load

    got = load("06_training_and_checkpoints").main()
    want = jax_example_06_losses()
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want)]
    assert max(rel) <= 1e-3, (got["losses"], want)
    assert got["bit_stable"] and got["restored_step"] == 5


def test_example_03_pck_equals_jax(on_cpu):
    import jax

    from examples_torch._common import load
    from perception_tpu.models import pose_fixture

    got = load("03_pose_keypoints_from_image").main()
    pck, recall = pose_fixture.evaluate_pck(pose_fixture.load_fixture(), jax.random.key(7), n_scenes=2)
    assert abs(got["pck"] - pck) <= 1e-9 and abs(got["recall"] - recall) <= 1e-9


def test_example_11_faces_equal_jax(on_cpu):
    import jax

    from examples_torch._common import load
    from perception_tpu.models import face_fixture as FF
    from perception_tpu.models.face import au_gated_pose_mask, head_pose_pnp, normalize_landmarks
    from perception_tpu.models.face_data import render_face, sample_face
    from perception_tpu.models.hand import crop_image

    got = load("11_trained_face_pipeline").main()["faces"]
    params = FF.load_fixture()
    hw, fx = FF.FIXTURE_HW, FF.FIXTURE_FX
    for i, face in enumerate(got):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.key(0), i))
        scene = sample_face(k1, hw, fx, fx)
        img = render_face(scene, hw, key=k2)
        det = FF.detect_with_net(params["det"], img)
        box = det.boxes[0]
        uv, m, _ = FF.landmarks_from_crop(params["landmark"], crop_image(img, box, FF.FIXTURE_CROP) / 255.0, box)
        inten, _ = FF.tiny_au_head().apply(params["au"], normalize_landmarks(uv, m))
        assert face["gate"] == bool(au_gated_pose_mask(inten))
        assert np.abs(face["landmarks"] - np.asarray(uv)).max() <= 1e-3
        T, _ = head_pose_pnp(uv, m, fx, fx, hw[1] / 2.0, hw[0] / 2.0)
        assert np.abs(face["pose"][:3, 3] - np.asarray(T)[:3, 3]).max() <= 1e-3
