"""The port's point-cloud and pose file formats against the JAX package's,
on the CPU.

``io/pcd.py``: ``read_pcd`` of the port equals the JAX package's
bit for bit on ascii and binary files of either writer, with NaN rows
dropped and extra fields skipped; another DATA mode raises; the two
writers write the same bytes; PLY (ascii, binary, extra properties) the
same. ``io/camera_params.py``: one rig file gives equal intrinsics,
distortion, extrinsics and P in both. ``io/gt_transforms.py``: the two
writers write the same text, and each reads the other's file to the same
poses within 1e-6 (the quaternion is computed in float32 on both sides).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from perception_tpu.geometry import se3 as jse3
from perception_tpu.io import camera_params as jparams
from perception_tpu.io import gt_transforms as jgt
from perception_tpu.io import pcd as jpcd
from perception_tpu_torch.io import camera_params as tparams
from perception_tpu_torch.io import gt_transforms as tgt
from perception_tpu_torch.io import pcd as tpcd


def cloud(seed, n):
    pts = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    pts[::17] = np.nan
    return pts


@pytest.mark.parametrize("binary", [False, True])
def test_pcd_files_read_and_written_alike(tmp_path, binary):
    pts = cloud(0, 300)
    tpcd.write_pcd(tmp_path / "t.pcd", pts, binary=binary)
    jpcd.write_pcd(tmp_path / "j.pcd", pts, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    got = tpcd.read_pcd(tmp_path / "j.pcd")
    np.testing.assert_array_equal(got, jpcd.read_pcd(tmp_path / "j.pcd"))
    assert got.shape == (300 - len(pts[::17]), 3) and got.dtype == np.float32
    if binary:
        np.testing.assert_array_equal(got, pts[np.isfinite(pts).all(1)])
    else:
        np.testing.assert_allclose(got, pts[np.isfinite(pts).all(1)], atol=1e-5)


def test_pcd_extra_fields_and_bad_mode(tmp_path):
    body = "\n".join(f"{x} {y} {z} {i}" for x, y, z, i in np.random.RandomState(2).randn(20, 4))
    header = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              "WIDTH 20\nHEIGHT 1\nPOINTS 20\nDATA ascii\n")
    (tmp_path / "e.pcd").write_text(header + body + "\n")
    np.testing.assert_array_equal(tpcd.read_pcd(tmp_path / "e.pcd"), jpcd.read_pcd(tmp_path / "e.pcd"))
    (tmp_path / "c.pcd").write_text(header.replace("DATA ascii", "DATA binary_compressed") + body)
    with pytest.raises(ValueError, match="binary_compressed"):
        tpcd.read_pcd(tmp_path / "c.pcd")


@pytest.mark.parametrize("binary", [False, True])
def test_ply_files_read_and_written_alike(tmp_path, binary):
    pts = np.random.RandomState(3).randn(57, 3).astype(np.float32)
    tpcd.write_ply(tmp_path / "t.ply", pts, binary=binary)
    jpcd.write_ply(tmp_path / "j.ply", pts, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tpcd.read_ply(tmp_path / "j.ply"), jpcd.read_ply(tmp_path / "j.ply"))
    (tmp_path / "rgb.ply").write_bytes(
        b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\n"
        b"property float z\nproperty uchar red\nend_header\n1.0 2.0 3.0 255\n4.0 5.0 6.0 0\n")
    np.testing.assert_array_equal(tpcd.read_ply(tmp_path / "rgb.ply"), [[1, 2, 3], [4, 5, 6]])


def test_camera_rig_loads_alike(tmp_path):
    K = np.array([[600.0, 0, 320.5], [0, 601.5, 240.25], [0, 0, 1]])
    E = np.eye(4)
    E[:3, 3] = (0.1, -0.02, 0.3)
    dist = np.array([0.1, -0.05, 0.001, 0.002, 0.01])
    rig = {"cam0": {"K": K, "width": 640, "height": 480},
           "cam1": {"K": K, "dist": dist, "extrinsics": E, "width": 320, "height": 240}}
    tparams.save_camera_rig(tmp_path / "t.json", rig)
    jparams.save_camera_rig(tmp_path / "j.json", rig)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    got, want = tparams.load_camera_rig(tmp_path / "j.json"), jparams.load_camera_rig(tmp_path / "j.json")
    assert set(got) == set(want) == {"cam0", "cam1"}
    for name in got:
        tc, jc = got[name]["camera"], want[name]["camera"]
        for f in ("fx", "fy", "cx", "cy"):
            assert np.float32(getattr(tc, f)) == np.float32(getattr(jc, f))
        np.testing.assert_array_equal(np.asarray(tc.dist, np.float32), np.asarray(jc.dist))
        assert (tc.width, tc.height) == (jc.width, jc.height)
        np.testing.assert_array_equal(got[name]["extrinsics"], want[name]["extrinsics"])
        np.testing.assert_array_equal(got[name]["P"], want[name]["P"])


def random_poses(seed, n=4):
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(["eraser", "clamp", "screwdriver", "marker"][:n]):
        T = np.eye(4)
        T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=3) * 0.8)))
        T[:3, 3] = rng.normal(size=3) * 0.4
        out[name] = T
    return out


def test_gt_transforms_written_and_read_alike(tmp_path):
    poses = random_poses(0)
    tgt.save_gt_transforms(tmp_path / "t.txt", poses)
    jgt.save_gt_transforms(tmp_path / "j.txt", poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for path in (tmp_path / "t.txt", tmp_path / "j.txt"):
        got, want = tgt.load_gt_transforms(path), jgt.load_gt_transforms(path)
        assert list(got) == list(want) == list(poses)
        for name in poses:
            np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[name], poses[name], atol=1e-6, rtol=0)


def test_gt_transforms_reads_the_reference_layout(tmp_path):
    text = """############# eraser #############
transforms:
  -
    header:
      seq: 0
      frame_id: "/camera_depth_optical_frame"
    child_frame_id: "/cuboid_frame"
    transform:
      translation:
        x: 0.1296
        y: -0.472
        z: -0.3316
      rotation:
        x: -0.348770910586
        y: -0.134146176401
        z: -0.0488837796102
        w: 0.926268876395
"""
    (tmp_path / "ref.txt").write_text(text)
    got, want = tgt.load_gt_transforms(tmp_path / "ref.txt"), jgt.load_gt_transforms(tmp_path / "ref.txt")
    np.testing.assert_allclose(got["eraser"], want["eraser"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["eraser"][:3, 3], [0.1296, -0.472, -0.3316], atol=1e-9)
