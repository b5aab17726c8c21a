"""The port's cuboid pipeline against the JAX package, end to end at 640x480.

Both sides get the same bench frames (numpy), the same camera and the
same preprocessed template (``convert.state_from_jax``), and the port is
fed JAX's own RANSAC triplets. Tolerances, for float32 rounding that
differs between XLA (which contracts into FMAs) and torch: accepted and
num_box_points equal; plane atol 1e-5; pose translation within 1e-4 m;
rotation entries within 1e-3; fitness rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry.camera import PinholeCamera as JCamera
from perception_tpu.models import cuboid as jcuboid
from perception_tpu.ops import points as JP
from perception_tpu.ops import ransac as jransac
from perception_tpu_torch.bench import scene
from perception_tpu_torch.convert import state_from_jax
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.cuboid import (
    CuboidConfig,
    cuboid_pipeline_batch,
    cuboid_pipeline_from_depth,
    cuboid_pipeline_step,
    estimate_cuboid_pose,
    template_features,
)

torch.set_num_threads(2)
CFG = CuboidConfig()
SEEDS = (0, 3, 6)


def jax_triplets(depth, jcam, key):
    """``ransac._sample_indices`` on the JAX pipeline's own RANSAC input."""
    o, s = 1, 2
    d = jnp.asarray(depth)[o::s, o::s]
    jcam = dataclasses.replace(
        jcam, fx=jcam.fx / s, fy=jcam.fy / s, cx=(jcam.cx - o) / s, cy=(jcam.cy - o) / s,
        width=d.shape[1], height=d.shape[0],
    )
    pts, m = jcam.backproject_depth(d)
    m = JP.passthrough(pts, m, 2, *CFG.z_limits)
    m = JP.passthrough(pts, m, 0, *CFG.x_limits)
    cpts, cm = JP.compact(pts, m, CFG.pre_capacity)
    d0, dm0 = JP.voxel_downsample(cpts, cm, CFG.voxel_size)
    _, dm = JP.compact_prefix(d0, dm0, CFG.work_capacity)
    return np.asarray(jransac._sample_indices(key, dm, CFG.ransac_hypotheses))


@pytest.fixture(scope="module")
def case():
    jcam = JCamera.d435_depth()
    tnp = scene.benchmark_template()
    jt, jn, jm = jcuboid.template_features(tnp, np.ones(len(tnp), bool), CFG)
    state = state_from_jax(np.asarray(jcam.K), jcam.width, jcam.height, jt, jn, jm, device="cpu")
    depths, gts = scene.bench_frames(state.camera, SEEDS)
    jres, idx = [], []
    for i, depth in enumerate(depths):
        key = jax.random.key(100 + i)
        jres.append(jcuboid.cuboid_pipeline_from_depth(
            jnp.asarray(depth), jcam, jt, jm, key, CFG, template_normals=jn))
        idx.append(jax_triplets(depth, jcam, key))
    return dict(state=state, depths=depths, gts=gts, jres=jres, idx=np.stack(idx))


def check_against_jax(res, jres):
    assert bool(res.accepted) == bool(jres.accepted)
    assert int(res.num_box_points) == int(jres.num_box_points)
    assert bool(res.plane_valid) == bool(jres.plane_valid)
    np.testing.assert_allclose(res.plane.numpy(), np.asarray(jres.plane), atol=1e-5, rtol=0)
    pose, jpose = res.pose.numpy(), np.asarray(jres.pose)
    np.testing.assert_allclose(pose[:3, 3], jpose[:3, 3], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pose[:3, :3], jpose[:3, :3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness), rtol=1e-3)
    np.testing.assert_allclose(res.bbox.numpy(), np.asarray(jres.bbox), atol=1e-3, rtol=0)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_pipeline_from_depth_matches_jax(case, i):
    st = case["state"]
    res = cuboid_pipeline_from_depth(
        torch.from_numpy(case["depths"][i]), st.camera, st.template, st.template_mask,
        None, CFG, template_normals=st.template_normals, indices=torch.from_numpy(case["idx"][i]),
    )
    assert res.pose.shape == (4, 4) and res.bbox.shape == (8, 3)
    check_against_jax(res, case["jres"][i])
    assert bool(res.accepted)


def test_pipeline_batch_matches_jax(case):
    st = case["state"]
    res = cuboid_pipeline_batch(
        torch.from_numpy(case["depths"]), st.camera, st.template, st.template_mask,
        None, CFG, template_normals=st.template_normals, indices=torch.from_numpy(case["idx"]),
    )
    assert res.pose.shape == (len(SEEDS), 4, 4) and res.num_box_points.dtype == torch.int32
    for i, jres in enumerate(case["jres"]):
        check_against_jax(type(res)(*(t[i] for t in res)), jres)


def test_pipeline_with_own_generator_finds_the_cuboid(case):
    st = case["state"]
    g = torch.Generator().manual_seed(0)
    res = cuboid_pipeline_batch(
        torch.from_numpy(case["depths"]), st.camera, st.template, st.template_mask,
        g, CFG, template_normals=st.template_normals,
    )
    assert bool(res.accepted.all())
    err = np.linalg.norm(res.pose[:, :3, 3].numpy() - case["gts"][:, :3, 3], axis=-1)
    assert np.all(err <= 0.02), err
    assert np.all(np.isfinite(res.bbox.numpy()))


def _template():
    tnp = scene.benchmark_template()
    return template_features(tnp, np.ones(len(tnp), bool), CFG, device="cpu")


def test_empty_scene_is_rejected():
    t, tn, tm = _template()
    depth = torch.full((480, 640), 0.85)
    res = cuboid_pipeline_from_depth(depth, PinholeCamera.d435_depth(), t, tm,
                                     torch.Generator().manual_seed(1), CFG, template_normals=tn)
    assert not bool(res.accepted) and int(res.num_box_points) < 50


def test_unported_modes_raise():
    """Every mode is ported now: p2p runs without normals; what still raises
    is point-to-plane without them and a batch that is not (B, H, W)."""
    t, tn, tm = _template()
    pts, mask = torch.zeros(64, 3), torch.zeros(64, dtype=torch.bool)
    g = torch.Generator()
    pose, fitness, _ = estimate_cuboid_pose(pts, mask, t, tm, CuboidConfig(icp_mode="p2p", icp_max_iterations=2))
    assert pose.shape == (4, 4) and bool(torch.isfinite(pose).all()) and float(fitness) == 0.0
    res = cuboid_pipeline_step(pts, mask, t, tm, g, dataclasses.replace(CuboidConfig.pcl_parity(),
                                                                        icp_max_iterations=2))
    assert not bool(res.accepted)
    with pytest.raises(ValueError, match="template_normals"):
        estimate_cuboid_pose(pts, mask, t, tm, CFG)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        cuboid_pipeline_batch(torch.zeros(480, 640), PinholeCamera.d435_depth(), t, tm, g, CFG,
                              template_normals=tn)
