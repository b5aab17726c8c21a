"""The port's keyframe SLAM system against the JAX package, frame by frame.

Scene: the 20-frame ``out_and_back_trajectory(n=20, radius=0.5)`` at
96x72 of ``test_slam_system.py`` with its ``slam_cfg()`` (BA on; loop
closures fire from the fourth frame on). The JAX ``slam_step`` loop runs
once per module (one XLA compile); the port replays its key sequence:
the port's ``_draw_triplets`` is replaced by ``jax.random.categorical``
over the pair mask with the key the JAX step got, so both steps score
the same RANSAC triplets.

Tolerances, as measured over the 19 steps: ``promoted``,
``loop_candidate``, ``ba_ran``, ``loop_matches``, ``loop_inliers`` and
the landmark and observation counts equal (the counts held to within 2,
the rest exact); BA costs within rtol 1e-5 (held to 1e-3); poses within
1.2e-5 in translation and rotation entries (held to 1e-4); final
keyframe poses the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.models.slam import system as js
from perception_tpu_torch import convert
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import system
from perception_tpu_torch.models.slam.odometry import OdometryConfig
from test_slam_system import cam, make_seq, out_and_back_trajectory, slam_cfg

torch.set_num_threads(2)


def port_config(jcfg):
    """The port's SlamConfig with the JAX config's values."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "odometry"}
    return system.SlamConfig(odometry=OdometryConfig(**dataclasses.asdict(jcfg.odometry)), **fields)


def test_slam_config_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(system.SlamConfig) if f.name != "odometry"]
    theirs = [(f.name, f.default) for f in dataclasses.fields(js.SlamConfig) if f.name != "odometry"]
    assert ours == theirs
    assert dataclasses.asdict(system.SlamConfig().odometry) == dataclasses.asdict(js.SlamConfig().odometry)


@pytest.fixture(scope="module")
def scene():
    jcam = cam()
    camera = PinholeCamera.from_K(np.asarray(jcam.K), jcam.width, jcam.height)
    gt = out_and_back_trajectory(n=20, radius=0.5)
    grays, depths = make_seq(jcam, gt)
    return jcam, camera, gt, grays, depths


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX loop: (per-step keys, numpy states (init first), numpy diags)."""
    jcam, _, _, grays, depths = scene
    cfg = slam_cfg()
    state = js.slam_init(jcam, jnp.asarray(depths[0]), jnp.asarray(grays[0]), cfg)
    key = jax.random.key(0)
    keys, states, diags = [], [jax.tree.map(np.asarray, state)], []
    for d, g in zip(depths[1:], grays[1:]):
        key, sub = jax.random.split(key)
        state, diag = js.slam_step(state, jnp.asarray(d), jnp.asarray(g), jcam, sub, cfg)
        keys.append(sub)
        states.append(jax.tree.map(np.asarray, state))
        diags.append(jax.tree.map(np.asarray, diag))
    return keys, states, diags


class JaxDraws:
    """Stands in for ``system._draw_triplets``: the JAX package's draw,
    ``jax.random.categorical`` over the mask with ``self.key``."""

    key = None

    def __call__(self, generator, mask, num):
        logits = jnp.where(jnp.asarray(mask.cpu().numpy()), 0.0, -jnp.inf)
        return torch.from_numpy(np.array(jax.random.categorical(self.key, logits, shape=(num, 3))))


@pytest.fixture
def draws(monkeypatch):
    d = JaxDraws()
    monkeypatch.setattr(system, "_draw_triplets", d)
    return d


def t(x):
    return torch.from_numpy(np.array(x))


def assert_step_matches(state, diag, want_state, want_diag):
    assert bool(diag.promoted) == bool(want_diag.promoted)
    assert int(diag.loop_candidate) == int(want_diag.loop_candidate)
    assert bool(diag.ba_ran) == bool(want_diag.ba_ran)
    assert int(diag.loop_matches) == int(want_diag.loop_matches)
    assert int(diag.loop_inliers) == int(want_diag.loop_inliers)
    np.testing.assert_allclose([float(diag.ba_cost0), float(diag.ba_cost1)],
                               [float(want_diag.ba_cost0), float(want_diag.ba_cost1)], rtol=1e-3)
    assert bool(state.loop_found) == bool(want_state.loop_found)
    assert abs(int(state.landmarks.count) - int(want_state.landmarks.count)) <= 2
    assert abs(int(state.obs.count) - int(want_state.obs.count)) <= 2
    np.testing.assert_allclose(state.odom.pose.numpy(), want_state.odom.pose, atol=1e-4, rtol=0)
    np.testing.assert_allclose(state.keyframes.poses.numpy(), want_state.keyframes.poses, atol=1e-4, rtol=0)


def test_slam_step_loop_matches_jax_frame_by_frame(scene, jax_run, draws):
    _, camera, gt, grays, depths = scene
    keys, states, diags = jax_run
    cfg = port_config(slam_cfg())
    state = system.slam_init(camera, t(depths[0]), t(grays[0]), cfg)
    gen = torch.Generator().manual_seed(0)
    ran = []
    for k, (d, g) in enumerate(zip(depths[1:], grays[1:])):
        draws.key = keys[k]
        state, diag = system.slam_step(state, t(d), t(g), camera, gen, cfg)
        assert_step_matches(state, diag, states[k + 1], diags[k])
        ran.append((bool(diag.promoted), bool(state.loop_found), bool(diag.ba_ran)))
    promoted, loops, ba = np.array(ran).sum(axis=0)
    assert promoted >= 5 and loops >= 3 and ba >= 5
    final = states[-1]
    np.testing.assert_array_equal(state.keyframes.stamp.numpy(), final.keyframes.stamp)
    np.testing.assert_array_equal(state.landmarks.mask.numpy(), final.landmarks.mask)
    np.testing.assert_array_equal(state.obs.mask.numpy(), final.obs.mask)
    np.testing.assert_array_equal(state.edges.mask.numpy(), final.edges.mask)
    np.testing.assert_allclose(state.edges.T.numpy(), final.edges.T, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k", [5, 12])  # the next frame is a promotion with a closure and BA
def test_converted_jax_state_steps_like_jax(scene, jax_run, draws, k):
    _, camera, _, grays, depths = scene
    keys, states, diags = jax_run
    assert bool(diags[k].promoted) and int(diags[k].loop_candidate) >= 0 and bool(diags[k].ba_ran)
    state = convert.slam_state_from_jax(states[k], device="cpu")
    assert state.keyframes.desc.dtype == torch.int32
    np.testing.assert_array_equal(state.keyframes.desc.numpy().view(np.uint32), states[k].keyframes.desc)
    draws.key = keys[k]
    new, diag = system.slam_step(state, t(depths[k + 1]), t(grays[k + 1]), camera,
                                 torch.Generator().manual_seed(0), port_config(slam_cfg()))
    assert_step_matches(new, diag, states[k + 1], diags[k])
