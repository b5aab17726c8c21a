"""The port's keyframe SLAM system on its own: the keyframe ring, the host
reads of ``slam_step``, the host-triggered correction mode and
``run_slam``, on the 96x72 out-and-back scene of ``test_slam_system.py``
(its helpers render the frames; no JAX step runs here).
"""

import dataclasses
import traceback

import numpy as np
import pytest
import torch

from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.slam import system
from perception_tpu_torch.utils.metrics import ate
from test_slam_system import cam, make_seq, out_and_back_trajectory, slam_cfg
from test_torch_slam import port_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    jcam = cam()
    camera = PinholeCamera.from_K(np.asarray(jcam.K), jcam.width, jcam.height)
    gt = out_and_back_trajectory(n=20, radius=0.5)
    grays, depths = make_seq(jcam, gt)
    return camera, np.stack(gt), [torch.from_numpy(g) for g in grays], [torch.from_numpy(d) for d in depths]


def test_slam_init_state():
    camera = PinholeCamera.from_K(np.asarray(cam().K), 96, 72)
    _, gray, depth = None, *make_seq(cam(), [np.eye(4)])
    st = system.slam_init(camera, torch.from_numpy(depth[0]), torch.from_numpy(gray[0]), port_config(slam_cfg()))
    assert st.keyframes.poses.shape == (16, 4, 4) and st.keyframes.desc.dtype == torch.int32
    assert bool(st.keyframes.valid[0]) and int(st.keyframes.count) == 1 and int(st.edges.count) == 0
    assert st.keyframes.stamp.tolist() == [0] + [-1] * 15
    assert int(st.keyframes.kp_mask[0].sum()) > 0 and not bool(st.keyframes.kp_mask[1:].any())
    with pytest.raises(ValueError):
        system.slam_init(camera, torch.from_numpy(depth[0]), torch.from_numpy(gray[0]),
                         dataclasses.replace(port_config(slam_cfg()), max_observations=100))


def test_keyframe_ring_evicts_oldest_and_drops_stale_edges(scene):
    """The assertions of the JAX package's ring test at max_keyframes=4."""
    camera, _, grays, depths = scene
    cfg = dataclasses.replace(port_config(slam_cfg()), max_keyframes=4, max_edges=12)
    state = system.slam_init(camera, depths[0], grays[0], cfg)
    gen = torch.Generator().manual_seed(0)
    for d, g in zip(depths[1:], grays[1:]):
        state, diag = system.slam_step(state, d, g, camera, gen, cfg)
        if bool(diag.promoted):
            stamps = state.keyframes.stamp
            for e in torch.nonzero(state.edges.mask)[:, 0]:
                assert int(stamps[state.edges.i[e]]) >= 0 and int(stamps[state.edges.j[e]]) >= 0
    count = int(state.keyframes.count)
    assert count > 4, "trajectory must overflow the ring"
    np.testing.assert_array_equal(np.sort(state.keyframes.stamp.numpy()), np.arange(count)[-4:])
    assert bool(state.keyframes.valid.all())
    # Observations of evicted keyframes are dead; live ones point at live slots.
    assert bool((state.keyframes.valid[state.obs.kf.long()] | ~state.obs.mask).all())


class HostReads:
    """Counts reads of tensor values to the host, by the port's calling line."""

    NAMES = ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "numpy")

    def __init__(self, monkeypatch):
        self.sites = []
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, self._wrap(getattr(torch.Tensor, name)))

    def _wrap(self, fn):
        def counted(t, *args, **kwargs):
            frames = [f for f in traceback.extract_stack()[:-1] if "perception_tpu_torch" in f.filename]
            self.sites.append(f"{frames[-1].name}" if frames else "outside the port")
            return fn(t, *args, **kwargs)
        return counted


@pytest.mark.parametrize("enable_ba", [True, False])
def test_slam_step_reads_promoted_once_per_tracking_frame(scene, monkeypatch, enable_ba):
    """A tracking frame reads ``promoted`` and nothing else; a promotion
    frame reads ``promoted``, ``loop_ok`` and (with BA) ``do_ba``."""
    camera, _, grays, depths = scene
    cfg = dataclasses.replace(port_config(slam_cfg()), enable_ba=enable_ba)
    state = system.slam_init(camera, depths[0], grays[0], cfg)
    gen = torch.Generator().manual_seed(0)
    steps = []
    for d, g in zip(depths[1:9], grays[1:9]):
        reads = HostReads(monkeypatch)
        state, diag = system.slam_step(state, d, g, camera, gen, cfg)
        monkeypatch.undo()
        steps.append((bool(diag.promoted), reads.sites))
    promoted = [p for p, _ in steps]
    assert 0 < sum(promoted) < len(promoted)
    for p, sites in steps:
        assert sites == ["_read_flag"] * ((2 + enable_ba) if p else 1), sites


def test_host_triggered_correction_matches_in_step(scene):
    """``correct_in_step=False`` applies each correction a frame late; with
    BA off both modes see the same promotions and closure candidates and
    end at the same pose (the JAX package's test, same tolerance)."""
    camera, _, grays, depths = scene
    fused = dataclasses.replace(port_config(slam_cfg()), enable_ba=False)
    host = dataclasses.replace(fused, correct_in_step=False)
    _, poses_f, diags_f = system.run_slam(camera, depths, grays, fused)
    _, poses_h, diags_h = system.run_slam(camera, depths, grays, host)
    for df, dh in zip(diags_f, diags_h):
        assert bool(df.promoted) == bool(dh.promoted)
        assert int(df.loop_candidate) == int(dh.loop_candidate)
    assert sum(int(d.loop_candidate) >= 0 for d in diags_f) >= 3
    np.testing.assert_allclose(poses_f[-1].numpy(), poses_h[-1].numpy(), atol=2e-3)


def test_run_slam_tracks_closes_loops_and_adjusts(scene):
    camera, gt, grays, depths = scene
    state, poses, diags = system.run_slam(camera, depths, grays, port_config(slam_cfg()))
    assert len(poses) == len(gt) and len(diags) == len(gt) - 1
    est = torch.stack(poses).numpy()
    assert ate(est.astype(np.float64), gt, align=False).max < 0.08
    assert int(((state.edges.weight == 2.0) & state.edges.mask).sum()) >= 1
    ba = [d for d in diags if bool(d.ba_ran)]
    assert ba and all(float(d.ba_cost1) <= float(d.ba_cost0) for d in ba)
    R = state.odom.pose[:3, :3]
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-4)
