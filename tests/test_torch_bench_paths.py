"""The port's per-path benchmarks (``perception_tpu_torch/bench/{pose_graph,
odometry, objects, pose}_bench.py``) against the JAX repository's
``benchmarks`` scripts on the CPU.

* ``pose_graph_bench.run(32, 96)`` against the JAX ``run(32, 96)``: the
  same keys and sizes; the costs within rtol 1e-4 and the mean
  translation error within 1e-4 m, ``test_torch_backend.py``'s pose-graph
  tolerances.
* ``odometry_bench``'s 10 sweep frames against the JAX script's, captured
  by spying on the ``init_state`` / ``odometry_step`` that its ``main``
  imports, and stopped after the timed loop's tenth frame (no JAX
  odometry runs): equal within 1e-6 m (both render in float64 from the
  float32 pose of their own ``se3_exp``, which agree within an ulp), and
  their order, warm-up frames 0 and 1 then frames 0-9.
* ``objects_bench``: the depth scene, the template of each class and the
  ``ObjectConfig`` that the JAX ``run`` builds, captured by spying on the
  scene functions and on ``detect_object`` (stopped at its first call),
  equal to the port's. The full ``run`` is left to the card: the CPU takes
  10-120 s a call.
* ``pose_bench.run`` at 64x64, B=2, 1 rep against the JAX ``run`` at the
  same settings: the same keys and settings; the image, batch, maps and
  heatmaps drawn from the JAX keys 1-4 within 2 ulps of ``jax.random``'s,
  and the weights from key 0 within 4 ulps of flax's init.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import clutter_scene as jclutter
from benchmarks import objects_bench as jax_objects
from benchmarks import odometry_bench as jax_odometry
from benchmarks import pose_bench as jax_pose
from benchmarks import pose_graph_bench as jax_pose_graph
from perception_tpu.models import objects as jobjects
from perception_tpu.models.slam import odometry as jodo
from perception_tpu_torch.bench import objects_bench, odometry_bench, pose_bench, pose_graph_bench
from perception_tpu_torch.convert import posenet_to_flax
from perception_tpu_torch.geometry.camera import PinholeCamera

torch.set_num_threads(2)

POSE_HW, POSE_BATCH = (64, 64), 2


class Captured(Exception):
    """Stops a JAX benchmark once its inputs are captured."""


def test_pose_graph_bench_matches_jax():
    got = pose_graph_bench.run(32, 96, device="cpu")
    want = jax_pose_graph.run(32, 96)
    assert set(got) == set(want) and len(got) == 7
    for k in ("nodes", "edges", "iterations"):
        assert got[k] == want[k]
    np.testing.assert_allclose([got["initial_cost"], got["final_cost"]], [want["initial_cost"], want["final_cost"]],
                               rtol=1e-4, atol=1e-9)
    assert abs(got["mean_translation_error_m"] - want["mean_translation_error_m"]) <= 1e-4
    assert got["final_cost"] < got["initial_cost"] * 0.2


def test_odometry_bench_frames_are_the_jax_scripts(monkeypatch):
    seen = []

    def init_state(cam, depth, cfg):
        seen.append(np.asarray(depth))
        return jnp.zeros(())

    def odometry_step(state, depth, cam, cfg):
        seen.append(np.asarray(depth))
        if len(seen) == 2 + odometry_bench.SWEEP_FRAMES:
            raise Captured
        return state, types.SimpleNamespace(overlap=1.0)

    monkeypatch.setattr(jodo, "init_state", init_state)
    monkeypatch.setattr(jodo, "odometry_step", odometry_step)
    with pytest.raises(Captured):
        jax_odometry.main()
    got = odometry_bench.sweep_frames(PinholeCamera.d435_depth())
    assert got.shape == (10, 480, 640) and got.dtype == np.float32
    want = np.stack(seen[2:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(seen[0], seen[2])  # the warm-up's frames 0 and 1
    np.testing.assert_array_equal(seen[1], seen[3])
    assert (got > 0).mean() > 0.99


def test_objects_bench_scene_and_config_are_the_jax_scripts(monkeypatch):
    seen = {"templates": {}}
    render, template = jclutter.render_depth_clutter, jclutter.captured_template

    def spy_render(cam, poses, **kwargs):
        depth = render(cam, poses, **kwargs)
        seen.setdefault("depth", depth)  # the scene; the templates' captures render after it
        return depth

    def spy_template(name, cam):
        seen["templates"][name] = template(name, cam)
        return seen["templates"][name]

    def detect_object(p, m, t, tm, k, cfg):
        seen["cfg"] = cfg
        raise Captured

    monkeypatch.setattr(jclutter, "render_depth_clutter", spy_render)
    monkeypatch.setattr(jclutter, "captured_template", spy_template)
    monkeypatch.setattr(jobjects, "detect_object", detect_object)
    with pytest.raises(Captured):
        jax_objects.run()
    camera, _, depth = objects_bench.scene()
    np.testing.assert_array_equal(depth, seen["depth"])
    assert list(seen["templates"]) == [objects_bench.CLASSES[0]]
    from perception_tpu_torch.bench.clutter_scene import captured_template

    np.testing.assert_array_equal(captured_template(objects_bench.CLASSES[0], camera),
                                  seen["templates"][objects_bench.CLASSES[0]])
    assert dataclasses.asdict(objects_bench.bench_config()) == dataclasses.asdict(seen["cfg"])
    assert jax_objects.run.__defaults__[0] == objects_bench.CLASSES


def test_pose_bench_matches_jax():
    got = pose_bench.run(net_hw=POSE_HW, batch=POSE_BATCH, reps=1, device="cpu")
    want = jax_pose.run(net_hw=POSE_HW, batch=POSE_BATCH, reps=1)
    assert set(got) == set(want) and len(got) == 10
    for k in ("topology", "net_hw", "batch", "reference_gpu_ms"):
        assert got[k] == want[k]
    assert all(got[k] > 0 for k in ("resize_merge_ms", "nms_ms", "extract_ms_batch1", "extract_fps_batch1",
                                    "extract_ms_per_frame_batch", "extract_fps_batch"))


def test_pose_bench_inputs_are_the_jax_keys():
    from perception_tpu.models.pose import PoseNet as JaxPoseNet
    from perception_tpu.models.pose import lookup_topology

    net, img, imgs, maps, hms = pose_bench.inputs(POSE_HW, "BODY_25", POSE_BATCH, "cpu")
    P = len(lookup_topology("BODY_25")[0])
    hw = POSE_HW
    want = [jax.random.uniform(jax.random.key(1), hw + (3,)),
            jax.random.uniform(jax.random.key(2), (POSE_BATCH,) + hw + (3,)),
            jax.random.uniform(jax.random.key(3), (P + 1, hw[0] // 8, hw[1] // 8)),
            jax.random.uniform(jax.random.key(4), (P,) + hw)]
    for g, w in zip((img, imgs, maps, hms), want):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=2)
    jnet = JaxPoseNet(num_parts=P, num_limbs=len(lookup_topology("BODY_25")[1]))
    params = jnet.init(jax.random.key(0), jnp.zeros((1,) + hw + (3,)))
    got_leaves = jax.tree_util.tree_leaves(posenet_to_flax(net))
    want_leaves = jax.tree_util.tree_leaves(params)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        # flax's truncated-normal draws through utils/jax_random's float32
        # erf_inv, scaled by the fan-in: a few dozen weights 1-4 ulps apart.
        np.testing.assert_array_max_ulp(np.asarray(g), np.asarray(w), maxulp=4)


def test_the_benchmarks_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (pose_graph_bench.run, odometry_bench.run, objects_bench.run, pose_bench.run):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run()
