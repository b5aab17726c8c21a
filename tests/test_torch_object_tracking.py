"""The port's streaming multi-object tracker and its kNN parts against the
JAX package on the CPU.

``knn``: indices equal, ties included (exact duplicate ref points, which
tie bit for bit and go to the lower index), distances within 1e-6.
``normals_knn``: normals within 1e-5, validity equal.

``track_step``: the tracking scene of ``benchmarks/tracking_scene.py``
(the port's numpy copy renders it, checked equal to the JAX copy) at
160x120 without decimation, three cuboids, over 6 frames: frame 0 runs
the full branch (every row) and the later frames the warm branch (all
slots latched with no miss). Both packages get the same template normals
(``normals_knn`` in JAX: kNN over a regular grid ties by rounding, which
the two matmuls break differently) and the JAX side's RANSAC triplets.
Slots and diagnostics equal, poses within 1 mm (translation) and 1e-3
(rotation entries), fitness within rtol 1e-3. ``track_slots_from_jax``
starts the port from a mid-run JAX state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import tracking_scene as jscene
from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.io.templates import cuboid_template
from perception_tpu.models import object_tracking as jtrack
from perception_tpu.models.objects import ObjectConfig as JObjectConfig
from perception_tpu.ops import nn as jnn
from perception_tpu.ops import normals as jnormals
from perception_tpu.ops import points as JP
from perception_tpu.ops import ransac as jransac
from perception_tpu_torch.bench import tracking_scene
from perception_tpu_torch.convert import track_slots_from_jax
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models import object_tracking as track
from perception_tpu_torch.models.objects import ObjectConfig
from perception_tpu_torch.ops import nn, normals

torch.set_num_threads(2)

W, H = 160, 120
FX = 384.0 * W / 640.0
DET = dict(table_z_cut=0.9, z_limits=(0.0, 0.9), x_limits=(-0.35, 0.35), voxel_size=0.005, cluster_min_size=20,
           cluster_capacity=512, offplane_capacity=2048, work_capacity=24576)
TRACK = dict(max_tracks=3, warm_icp_iterations=24, depth_stride=1)
FRAMES = 6


@pytest.mark.parametrize("tile", [64, 2048])
def test_knn_matches_with_ties(tile):
    rng = np.random.RandomState(0)
    ref = rng.uniform(-0.2, 0.2, (300, 3)).astype(np.float32)
    ref[200:260] = ref[10:70]                      # exact copies in a later tile
    mask = rng.rand(300) > 0.1
    mask[10:70] = mask[200:260] = True
    query = np.concatenate([ref[10:70], rng.uniform(-0.2, 0.2, (40, 3))]).astype(np.float32)
    jidx, jd2 = jnn.knn(jnp.asarray(query), jnp.asarray(ref), jnp.asarray(mask), k=8, tile=tile)
    idx, d2 = nn.knn(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(mask), k=8, tile=tile)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-6, rtol=0)
    assert idx[:60, 0].tolist() == list(range(10, 70)) and idx[:60, 1].tolist() == list(range(200, 260))


def test_normals_knn_matches():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-0.1, 0.1, (600, 3)).astype(np.float32)
    pts[:, 2] = 0.8 + 0.05 * np.sin(pts[:, 0] * 20)
    mask = rng.rand(600) > 0.1
    jn, jv = jnormals.normals_knn(jnp.asarray(pts), jnp.asarray(mask), k=8)
    n, v = normals.normals_knn(torch.from_numpy(pts), torch.from_numpy(mask), k=8)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def run():
    """Both trackers over the first frames of the sweep, frame by frame."""
    K = [FX, 0, W / 2, 0, FX, H / 2, 0, 0, 1]
    jcam, cam = JCamera.from_K(K, width=W, height=H), PinholeCamera.from_K(K, W, H)
    jcfg = jtrack.TrackingConfig(detection=JObjectConfig(**DET), **TRACK)
    cfg = track.TrackingConfig(detection=ObjectConfig(**DET), **TRACK)
    tmpls = [cuboid_template(*dims, density=0.006) for dims, _ in jscene.CUBOID_SET]
    nt = max(len(t) for t in tmpls)
    templates, tmasks = np.zeros((3, nt, 3), np.float32), np.zeros((3, nt), bool)
    for k, t in enumerate(tmpls):
        templates[k, :len(t)], tmasks[k, :len(t)] = t, True
    tn = np.array(jax.vmap(lambda t, m: jnormals.normals_knn(t, m, k=8)[0])(jnp.asarray(templates),
                                                                          jnp.asarray(tmasks)))
    traj, jtraj = tracking_scene.camera_trajectory(300), jscene.camera_trajectory(300)
    jslots, slots = jtrack.init_tracks(jcfg), track.init_tracks(cfg, device="cpu")
    key = jax.random.key(0)
    steps, depths = [], []
    for i in range(FRAMES):
        depth, gt = tracking_scene.render_depth_cuboids(cam, traj[i], seed=i)
        jdepth, _ = jscene.render_depth_cuboids(jcam, jtraj[i], seed=i)
        key, sub = jax.random.split(key)
        jslots_in = jslots
        jslots, jdiag = jtrack.track_step_from_depth(jslots, jnp.asarray(jdepth), jcam, jnp.asarray(templates),
                                                     jnp.asarray(tmasks), sub, jcfg,
                                                     template_normals=jnp.asarray(tn))
        pts, valid = jcam.backproject_depth(jnp.asarray(jdepth), min_depth=0.05, max_depth=5.0)
        m = JP.passthrough(pts, valid, 2, *DET["z_limits"])
        m = JP.passthrough(pts, m, 0, *DET["x_limits"])
        _, dm = JP.voxel_downsample(pts, m, DET["voxel_size"])
        idx = torch.from_numpy(np.array(jransac._sample_indices(sub, dm, 1024)))
        slots, diag = track.track_step_from_depth(slots, torch.from_numpy(depth), cam, torch.from_numpy(templates),
                                                  torch.from_numpy(tmasks), None, cfg,
                                                  template_normals=torch.from_numpy(tn), indices=idx)
        steps.append(dict(jslots=jslots, jdiag=jdiag, slots=slots, diag=diag, gt=gt, idx=idx,
                          jslots_in=jslots_in))
        depths.append((depth, jdepth))
    return dict(steps=steps, depths=depths, cam=cam, cfg=cfg, templates=templates, tmasks=tmasks, tn=tn)


def check_slots(slots, jslots):
    for name in ("latched", "misses", "age"):
        np.testing.assert_array_equal(getattr(slots, name).numpy(), np.asarray(getattr(jslots, name)), err_msg=name)
    pose, jpose = slots.pose.numpy(), np.asarray(jslots.pose)
    np.testing.assert_allclose(pose[:, :3, 3], jpose[:, :3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(pose[:, :3, :3], jpose[:, :3, :3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(slots.fitness.numpy(), np.asarray(jslots.fitness), rtol=1e-3)


@pytest.mark.parametrize("i", range(FRAMES))
def test_track_step_matches(run, i):
    step = run["steps"][i]
    check_slots(step["slots"], step["jslots"])
    diag, jdiag = step["diag"], step["jdiag"]
    for name in ("num_clusters", "assigned", "used_warm"):
        np.testing.assert_array_equal(getattr(diag, name).numpy(), np.asarray(getattr(jdiag, name)), err_msg=name)
    np.testing.assert_allclose(diag.fresh_fitness.numpy(), np.asarray(jdiag.fresh_fitness), rtol=1e-3)
    latched_in = np.asarray(step["jslots_in"].latched)
    # Frame 0 solves every row; from frame 1 on every slot is latched with no
    # miss, so only the warm rows run.
    assert latched_in.all() == (i > 0)
    err = np.linalg.norm(step["slots"].pose[:, :3, 3].numpy() - np.stack(step["gt"])[:, :3, 3], axis=1)
    assert bool(step["slots"].latched.all()) and np.all(err < 0.02)


def test_scene_copy_matches(run):
    depth, jdepth = run["depths"][0]
    np.testing.assert_array_equal(depth, jdepth)
    np.testing.assert_allclose(np.stack(tracking_scene.object_world_poses()),
                               np.stack(jscene.object_world_poses()), atol=1e-7, rtol=0)


def test_step_from_converted_jax_slots(run):
    """track_slots_from_jax carries the JAX tracker's mid-run slots; one step
    from them agrees with the JAX step."""
    step = run["steps"][FRAMES - 1]
    slots = track_slots_from_jax(jax.tree_util.tree_map(np.asarray, step["jslots_in"]), device="cpu")
    assert slots.misses.dtype == torch.int32 and slots.latched.dtype == torch.bool
    new, _ = track.track_step_from_depth(slots, torch.from_numpy(run["depths"][FRAMES - 1][0]), run["cam"],
                                         torch.from_numpy(run["templates"]), torch.from_numpy(run["tmasks"]), None,
                                         run["cfg"], template_normals=torch.from_numpy(run["tn"]), indices=step["idx"])
    check_slots(new, step["jslots"])


def test_template_normals_by_default():
    """Without template_normals the step derives them per slot (normals_knn, k=8)."""
    tm = cuboid_template(0.09, 0.06, 0.04, density=0.01)
    t = torch.from_numpy(tm)[None]
    m = torch.ones(1, len(tm), dtype=torch.bool)
    got = track.slot_template_normals(t, m)
    want = np.asarray(jnormals.normals_knn(jnp.asarray(tm), jnp.ones(len(tm), bool), k=8)[0])
    agree = np.abs(np.sum(got[0].numpy() * want, axis=1))
    assert got.shape == (1, len(tm), 3) and np.median(agree) > 0.999
