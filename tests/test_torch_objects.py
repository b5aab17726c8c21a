"""The port's detection service and the cuboid pipeline's ``cc`` and ``p2p``
modes against the JAX package on the CPU.

``detect_object``: the clutter scene of ``benchmarks/clutter_scene.py``
(the port's numpy copy renders it, checked equal to the JAX copy) through
a 160x120 camera at fx 192 (the objects at the density of a 320x240
D435), with a reduced ``ObjectConfig``, the JAX side's own RANSAC
triplets passed as ``indices``. Success, cluster id, cluster sizes,
``num_clusters`` and size difference equal; the pose within 1 mm
(translation) and 1e-3 (rotation entries); fitness within rtol 1e-3 (the
ICP sums run in other orders). A plate that matches no cluster is
rejected with cluster id -1 by both.

Cuboid modes: one bench frame at 640x480 through ``cluster_filter="cc"``
and ``icp_mode="p2p"``, with the tolerances of ``test_torch_cuboid.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import clutter_scene as jscene
from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.io.templates import box_surface_template as jbox
from perception_tpu.models import cuboid as jcuboid
from perception_tpu.models import objects as jobjects
from perception_tpu.ops import points as JP
from perception_tpu.ops import ransac as jransac
from perception_tpu_torch.bench import clutter_scene, scene
from perception_tpu_torch.convert import state_from_jax
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.io.templates import box_surface_template
from perception_tpu_torch.models import objects
from perception_tpu_torch.models.cuboid import CuboidConfig, cuboid_pipeline_batch, cuboid_pipeline_from_depth
from test_torch_cuboid import check_against_jax

torch.set_num_threads(2)

K = [192.0, 0.0, 80.0, 0.0, 192.0, 60.0, 0.0, 0.0, 1.0]
SMALL = dict(cluster_min_size=20, work_capacity=8192, offplane_capacity=2048, cluster_capacity=256,
             icp_max_iterations=30)


def jax_working_mask(pts, mask, cfg):
    m = JP.passthrough(pts, mask, 2, *cfg.z_limits)
    m = JP.passthrough(pts, m, 0, *cfg.x_limits)
    dpts, dm = JP.voxel_downsample(pts, m, cfg.voxel_size)
    if dpts.shape[0] > cfg.work_capacity:
        dpts, dm = JP.compact_prefix(dpts, dm, cfg.work_capacity)
    return dm


@pytest.fixture(scope="module")
def clutter():
    jcam, cam = JCamera.from_K(K, width=160, height=120), PinholeCamera.from_K(K, 160, 120)
    poses, jposes = clutter_scene.standard_clutter_poses(), jscene.standard_clutter_poses()
    depth = clutter_scene.render_depth_clutter(cam, poses, seed=3)
    pts, mask = jcam.backproject_depth(jnp.asarray(depth))
    return dict(jcam=jcam, cam=cam, poses=poses, jposes=jposes, depth=depth, pts=pts, mask=mask)


def test_clutter_scene_copy_matches(clutter):
    for name in clutter["poses"]:
        np.testing.assert_allclose(clutter["poses"][name], clutter["jposes"][name], atol=1e-7, rtol=0)
        np.testing.assert_allclose(clutter_scene.captured_template(name, clutter["cam"]),
                                   jscene.captured_template(name, clutter["jcam"]), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(clutter_scene.class_template(name), jscene.class_template(name))
    jdepth = jscene.render_depth_clutter(clutter["jcam"], clutter["jposes"], seed=3)
    np.testing.assert_allclose(clutter["depth"], jdepth, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(box_surface_template((0.3, 0.3, 0.02), 0.003), jbox((0.3, 0.3, 0.02), 0.003))


def run_both(clutter, template, seed):
    jcfg, cfg = jobjects.ObjectConfig(**SMALL), objects.ObjectConfig(**SMALL)
    key = jax.random.key(seed)
    jres = jobjects.detect_object(clutter["pts"], clutter["mask"], jnp.asarray(template),
                                  jnp.ones(len(template), bool), key, jcfg)
    dm = jax_working_mask(clutter["pts"], clutter["mask"], jcfg)
    idx = np.array(jransac._sample_indices(key, dm, jcfg.ransac_hypotheses))
    res = objects.detect_object(
        torch.from_numpy(np.array(clutter["pts"])), torch.from_numpy(np.array(clutter["mask"])),
        torch.from_numpy(template), torch.ones(len(template), dtype=torch.bool), None, cfg,
        indices=torch.from_numpy(idx))
    for name in ("success", "cluster_id", "size_diff", "num_clusters", "cluster_sizes"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(jres, name)), err_msg=name)
    return res, jres


@pytest.mark.parametrize("name,seed", [("eraser", 7), ("clamp", 8)])
def test_detect_object_matches(clutter, name, seed):
    res, jres = run_both(clutter, clutter_scene.captured_template(name, clutter["cam"]), seed)
    assert bool(res.success)
    pose, jpose = res.pose.numpy(), np.asarray(jres.pose)
    np.testing.assert_allclose(pose[:3, 3], jpose[:3, 3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(pose[:3, :3], jpose[:3, :3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness), rtol=1e-3)
    assert res.pose.shape == (4, 4) and res.cluster_id.dtype == torch.int32
    assert np.linalg.norm(pose[:3, 3] - clutter["poses"][name][:3, 3]) < 0.02


def test_detect_object_rejects_a_plate(clutter):
    res, _ = run_both(clutter, box_surface_template((0.3, 0.3, 0.02), 0.01), 9)
    assert not bool(res.success) and int(res.cluster_id) == -1


@pytest.fixture(scope="module")
def bench_frame():
    jcam = JCamera.d435_depth()
    tnp = scene.benchmark_template()
    cfg = CuboidConfig()
    jt, jn, jm = jcuboid.template_features(tnp, np.ones(len(tnp), bool), cfg)
    state = state_from_jax(np.asarray(jcam.K), jcam.width, jcam.height, jt, jn, jm, device="cpu")
    depths, gts = scene.bench_frames(state.camera, (2,))
    return dict(jcam=jcam, jt=jt, jn=jn, jm=jm, state=state, depth=depths[0], gt=gts[0])


@pytest.mark.parametrize("mode", [dict(cluster_filter="cc"), dict(icp_mode="p2p")])
def test_cuboid_modes_match(bench_frame, mode):
    from test_torch_cuboid import jax_triplets

    jcfg, cfg = jcuboid.CuboidConfig(**mode), CuboidConfig(**mode)
    key = jax.random.key(11)
    jres = jcuboid.cuboid_pipeline_from_depth(jnp.asarray(bench_frame["depth"]), bench_frame["jcam"],
                                              bench_frame["jt"], bench_frame["jm"], key, jcfg,
                                              template_normals=bench_frame["jn"])
    st = bench_frame["state"]
    res = cuboid_pipeline_from_depth(
        torch.from_numpy(bench_frame["depth"]), st.camera, st.template, st.template_mask, None, cfg,
        template_normals=st.template_normals,
        indices=torch.from_numpy(jax_triplets(bench_frame["depth"], bench_frame["jcam"], key)))
    check_against_jax(res, jres)
    assert bool(res.accepted)
    assert np.linalg.norm(res.pose[:3, 3].numpy() - bench_frame["gt"][:3, 3]) <= 0.02


def test_pcl_parity_config_matches():
    assert dataclasses.asdict(CuboidConfig.pcl_parity()) == dataclasses.asdict(jcuboid.CuboidConfig.pcl_parity())
    assert [(f.name, f.default) for f in dataclasses.fields(objects.ObjectConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jobjects.ObjectConfig)]


def test_cuboid_p2p_errors_match_jax():
    """Point-to-point at the default 20 iterations on the 8 bench frames: the
    port (JAX triplets) lands where the JAX package does, within 0.1 mm, and
    the JAX package's errors are those chip_smoke.py gates the card with."""
    from chip_smoke import P2P_JAX_ERROR_MM
    from test_torch_cuboid import jax_triplets

    jcam, tnp = JCamera.d435_depth(), scene.benchmark_template()
    jcfg, cfg = jcuboid.CuboidConfig(icp_mode="p2p"), CuboidConfig(icp_mode="p2p")
    jt, jn, jm = jcuboid.template_features(tnp, np.ones(len(tnp), bool), jcfg)
    st = state_from_jax(np.asarray(jcam.K), jcam.width, jcam.height, jt, jn, jm, device="cpu")
    depths, gts = scene.bench_frames(st.camera, range(8))
    jerr, idx = [], []
    for i, depth in enumerate(depths):
        key = jax.random.key(200 + i)
        jres = jcuboid.cuboid_pipeline_from_depth(jnp.asarray(depth), jcam, jt, jm, key, jcfg, template_normals=jn)
        jerr.append(np.linalg.norm(np.asarray(jres.pose)[:3, 3] - gts[i][:3, 3]) * 1e3)
        idx.append(jax_triplets(depth, jcam, key))
    res = cuboid_pipeline_batch(torch.from_numpy(depths), st.camera, st.template, st.template_mask, None, cfg,
                                template_normals=st.template_normals, indices=torch.from_numpy(np.stack(idx)))
    err = np.linalg.norm(res.pose[:, :3, 3].numpy() - gts[:, :3, 3], axis=1) * 1e3
    np.testing.assert_allclose(err, jerr, atol=0.1, rtol=0)
    np.testing.assert_allclose(jerr, P2P_JAX_ERROR_MM, atol=0.1, rtol=0)
    assert bool(res.accepted.all()) and max(jerr) > 20.0  # the reference itself misses 2 cm
