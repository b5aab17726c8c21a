"""The port's SLAM odometry against the JAX package, on the 80x60 camera
and the room of ``test_odometry.py``.

Every engine ``OdometryConfig`` selects runs the same depth frames in
both packages. The JAX step is one ``jax.jit``, where XLA contracts
multiply-adds into FMAs and folds divisions by constants; the port rounds
each operation. Measured over 5 frames the poses agree within 4e-7, so
they are held to atol 1e-5; the promotion decisions equal; correspondence
counts within 2 and the overlap within 5e-3 (a rounding tie may move one
correspondence); fitness within rtol 1e-3; the shortlist-miss / hash
overflow fractions within 1e-2. The kernels' plain versions run here;
the kernels are held against them on the card (``test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu.models.slam import odometry as jodo
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import odometry as odo
from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query
from perception_tpu_torch.utils.metrics import ate
from test_odometry import render_room_depth, small_camera, trajectory

torch.set_num_threads(2)

BASE = dict(point_budget=512, keyframe_budget=1024, icp_iterations=6, min_depth=0.1,
            max_depth=6.0, normal_max_edge=0.5, kf_translation=0.05)
MAP = dict(map_budget=4096, map_voxel=0.03, map_nn_radius=0.12)
ENGINES = {
    "keyframe-auto": {},
    "keyframe-fused": dict(fused_gn="on"),
    "map-auto": MAP,
    "map-brute": dict(MAP, map_nn="brute"),
    "map-hash": dict(MAP, map_nn="hash"),
    "map-hash-decay": dict(MAP, map_nn="hash", map_decay=0.5),
    "map-shortlist-exact-refresh-coarse": dict(MAP, map_nn="shortlist", map_nn_recall=1.0,
                                               map_nn_refresh=2, map_nn_coarse=2),
}


@pytest.fixture(scope="module")
def scene():
    jcam = small_camera()
    cam = PinholeCamera.from_K(np.asarray(jcam.K), jcam.width, jcam.height)
    gt = trajectory(5)
    depths = [render_room_depth(jcam, T, seed=i) for i, T in enumerate(gt)]
    return jcam, cam, gt, depths


def configs(name):
    return jodo.OdometryConfig(**BASE, **ENGINES[name]), odo.OdometryConfig(**BASE, **ENGINES[name])


def assert_diags_close(got, want):
    assert bool(got.promoted) == bool(want.promoted)
    assert abs(int(got.num_corr) - int(want.num_corr)) <= 2
    assert abs(float(got.overlap) - float(want.overlap)) <= 5e-3
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3)
    assert abs(float(got.nn_overflow) - float(want.nn_overflow)) <= 1e-2
    assert got.num_corr.dtype == torch.int32 and got.promoted.dtype == torch.bool


def test_config_fields_and_defaults_match():
    assert [(f.name, f.default) for f in dataclasses.fields(odo.OdometryConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jodo.OdometryConfig)
    ]


def check_run_against_jax(scene, engine):
    jcam, cam, gt, depths = scene
    jcfg, cfg = configs(engine)
    jposes, jdiags = jodo.run_odometry(jcam, depths, jcfg)
    poses, diags = odo.run_odometry(cam, depths, cfg)
    assert len(poses) == len(jposes) == len(depths)
    for p, jp in zip(poses, jposes):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    for d, jd in zip(diags, jdiags):
        assert_diags_close(d, jd)
    assert any(bool(d.promoted) for d in diags)  # the map / keyframe update ran
    est = np.stack([p.numpy() for p in poses])
    assert ate(est, np.stack(gt), align=False).rmse < 0.02
    assert all(float(d.overlap) > 0.5 for d in diags)


# The other map engines run in test_torch_odometry_map.py: each JAX
# configuration costs a few seconds of XLA compilation.
@pytest.mark.parametrize("engine", ["keyframe-auto", "keyframe-fused", "map-auto", "map-brute"])
def test_run_odometry_matches_jax_under_every_engine(scene, engine):
    check_run_against_jax(scene, engine)


def test_cpu_run_launches_no_kernel(scene):
    _, cam, _, depths = scene
    before = (gn_system_packed.launches, voxelhash_query.launches)
    for engine in ("keyframe-fused", "map-hash"):
        odo.run_odometry(cam, depths[:3], configs(engine)[1])
    assert (gn_system_packed.launches, voxelhash_query.launches) == before
