"""The port's checkpoints and fixture files against the JAX package's on the
CPU: ``utils/checkpoint.py`` and the fixtures' ``save_fixture``.

Everything here is held bit for bit:

- ``SlamState`` npz files, a keyframe-mode state (``test_checkpoint.py``'s
  ``small_state``) and a map-mode state on the voxel hash (80x60 room of
  ``test_odometry.py``, map budget 1024): JAX ``save_npz`` -> port
  ``load_npz`` equal to ``convert.slam_state_from_jax`` of the state, into
  a structure whose values were zeroed; port ``save_npz`` -> JAX
  ``load_npz`` equal to the JAX state, with ``KeyframeStore.desc`` uint32
  (its bits viewed, not converted), counts int32 and masks bool (the
  dtypes ``test_npz_roundtrip_preserves_dtypes`` checks) and the hash's
  ``tableT`` the transposed table;
- ``save_torch`` / ``load_torch`` (the port's ``save_orbax``), zero-size
  leaves included;
- a session resumed mid-stream on the CPU: ``slam_step`` over
  ``test_slam_system.py``'s 20-frame 96x72 out-and-back scene, saved with
  ``save_npz`` after frame 10 (the state and the generator's state), the
  live state dropped, loaded into a fresh ``slam_init`` skeleton and run
  on: every pose equal to the uninterrupted run's;
- ``install_snapshot_handler`` in a child process that gets SIGTERM: the
  snapshot is written, then the process dies of the signal;
- fixture files: port ``save_fixture`` read back by flax against the
  fixture's template (as the JAX ``load_fixture`` reads it; the hand through
  the JAX ``load_fixture`` itself) equal to the weights rounded to float16;
  the committed fixtures through the port's ``load_fixture`` and
  ``save_fixture`` byte-equal to the files.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from perception_tpu.models import face_fixture as jff
from perception_tpu.models import hand_fixture as jhf
from perception_tpu.models import pose_fixture as jpf
from perception_tpu.models.slam.odometry import OdometryConfig
from perception_tpu.models.slam.system import SlamConfig, slam_init
from perception_tpu.utils import checkpoint as jck
from perception_tpu_torch.convert import slam_state_from_jax
from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models import face_fixture, hand_fixture, pose_fixture
from perception_tpu_torch.models.slam import system
from perception_tpu_torch.utils import checkpoint
from test_checkpoint import small_state
from test_odometry import render_room_depth, small_camera, trajectory

torch.set_num_threads(2)


def map_state():
    cam = small_camera()
    depth = jnp.asarray(render_room_depth(cam, trajectory(1)[0], seed=0))
    cfg = SlamConfig(odometry=OdometryConfig(point_budget=256, keyframe_budget=512, map_budget=1024, map_nn="hash"),
                     max_keyframes=8, max_edges=16, features_per_kf=64)
    return slam_init(cam, depth, depth / depth.max(), cfg)


@pytest.fixture(scope="module", params=["keyframe", "map"])
def jax_state(request):
    state = small_state() if request.param == "keyframe" else map_state()
    return jax.tree.map(np.asarray, state)


def port_leaves(state):
    return [leaf for _, leaf in checkpoint._leaves(state)]


def zeroed(state):
    return checkpoint._unflatten(state, iter([torch.zeros_like(t) for t in port_leaves(state)]))


def test_jax_file_loads_into_the_port(jax_state, tmp_path):
    jck.save_npz(tmp_path / "s.npz", jax_state)
    want = slam_state_from_jax(jax_state, device="cpu")
    got = checkpoint.load_npz(tmp_path / "s.npz", zeroed(want))
    assert type(got) is system.SlamState
    for a, b in zip(port_leaves(got), port_leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.keyframes.desc.dtype == torch.int32


def test_port_file_loads_into_jax(jax_state, tmp_path):
    checkpoint.save_npz(tmp_path / "s", slam_state_from_jax(jax_state, device="cpu"))
    like = jax.tree.map(jnp.zeros_like, jax_state)
    back = jck.load_npz(tmp_path / "s", like)
    assert type(back).__name__ == "SlamState"
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(jax_state), strict=True):
        assert np.asarray(a).dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    assert back.keyframes.desc.dtype == jnp.uint32
    assert back.keyframes.count.dtype == jnp.int32
    assert back.keyframes.valid.dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(back.odom.map_hash.tableT), jax_state.odom.map_hash.table.T)


def test_save_torch_roundtrip_with_empty_leaves(jax_state, tmp_path):
    state = slam_state_from_jax(jax_state, device="cpu")
    tree = {"state": state, "empty": torch.zeros(0, 3), "step": 7, "rate": 0.5, "nothing": None}
    checkpoint.save_torch(tmp_path / "s.pt", tree)
    like = {"state": zeroed(state), "empty": torch.ones(0, 3), "step": 0, "rate": 0.0, "nothing": None}
    back = checkpoint.load_torch(tmp_path / "s.pt", like)
    for a, b in zip(port_leaves(back["state"]), port_leaves(state), strict=True):
        assert torch.equal(a, b)
    assert back["empty"].shape == (0, 3) and back["step"] == 7 and back["rate"] == 0.5 and back["nothing"] is None


def test_resume_mid_stream_matches_uninterrupted(tmp_path):
    from test_slam_system import cam, make_seq, out_and_back_trajectory, slam_cfg
    from test_torch_slam import port_config

    jcam = cam()
    camera = PinholeCamera.from_K(np.asarray(jcam.K), jcam.width, jcam.height)
    grays, depths = make_seq(jcam, out_and_back_trajectory(n=20, radius=0.5))
    grays, depths = [torch.from_numpy(g) for g in grays], [torch.from_numpy(d) for d in depths]
    cfg = port_config(slam_cfg())

    def run(state, gen, frames, poses):
        for i in frames:
            state, _ = system.slam_step(state, depths[i], grays[i], camera, gen, cfg)
            poses.append(state.odom.pose.clone())
        return state

    ref = []
    run(system.slam_init(camera, depths[0], grays[0], cfg), torch.Generator().manual_seed(0), range(1, 20), ref)

    poses, gen = [], torch.Generator().manual_seed(0)
    state = run(system.slam_init(camera, depths[0], grays[0], cfg), gen, range(1, 11), poses)
    checkpoint.save_npz(tmp_path / "ck", {"slam": state, "rng": gen.get_state()})
    del state, gen  # the host dies here
    skeleton = {"slam": system.slam_init(camera, depths[0], grays[0], cfg), "rng": torch.Generator().get_state()}
    restored = checkpoint.load_npz(tmp_path / "ck", skeleton)
    gen = torch.Generator()
    gen.set_state(restored["rng"])
    run(restored["slam"], gen, range(11, 20), poses)
    assert len(poses) == len(ref) == 19
    for a, b in zip(poses, ref):
        assert torch.equal(a, b)


def test_snapshot_handler_on_sigterm(tmp_path):
    out = tmp_path / "snap.npz"
    code = textwrap.dedent(f"""
        import time, torch
        from perception_tpu_torch.utils import checkpoint
        state = {{"w": torch.arange(5.0)}}
        checkpoint.install_snapshot_handler(lambda: checkpoint.save_npz({str(out)!r}, state))
        print("ready", flush=True)
        time.sleep(60)
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                            cwd=str(Path(__file__).resolve().parents[1]))
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.terminate()
        assert proc.wait(timeout=30) == -15
    finally:
        if proc.poll() is None:
            proc.kill()
    back = checkpoint.load_npz(out, {"w": torch.zeros(5)})
    assert torch.equal(back["w"], torch.arange(5.0))


# --- fixture files ------------------------------------------------------------

FIXTURES = {"pose": (pose_fixture, jpf), "hand": (hand_fixture, jhf), "face": (face_fixture, jff)}


def flax_read(jmod, path):
    """What the JAX ``load_fixture`` returns, without compiling its
    template: flax's ``from_bytes`` into the shapes of ``init_tiny``."""
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float16), jax.eval_shape(jmod.init_tiny, jax.random.key(0)))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), serialization.from_bytes(template, path.read_bytes()))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_save_fixture_reads_back_in_jax(name, tmp_path):
    mod, jmod = FIXTURES[name]
    net = mod.init_tiny(torch.Generator().manual_seed(1), "cpu")
    path = tmp_path / f"{name}.msgpack"
    mod.save_fixture(net, path)
    got = flax_read(jmod, path)
    if name == "hand":
        jgot = jax.tree.map(np.asarray, jmod.load_fixture(path))
        for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(got), strict=True):
            np.testing.assert_array_equal(a, b)
    back = mod.load_fixture("cpu", path)
    nets = {"": (net, back)} if name != "face" else {k: (net[k], back[k]) for k in ("landmark", "au", "det")}
    for key, (orig, loaded) in nets.items():
        for (n, a), (_, b) in zip(orig.state_dict().items(), loaded.state_dict().items(), strict=True):
            assert torch.equal(a.half().float(), b), f"{key}.{n}"
    total = sum(np.asarray(x).size for x in jax.tree.leaves(got))
    assert total == sum(p.numel() for p in net.parameters())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_committed_fixture_roundtrips_byte_equal(name, tmp_path):
    mod, _ = FIXTURES[name]
    path = tmp_path / "again.msgpack"
    mod.save_fixture(mod.load_fixture("cpu"), path)
    assert path.read_bytes() == mod.FIXTURE_PATH.read_bytes()
