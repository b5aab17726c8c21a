"""The training halves of the port's data modules against the JAX
package's on the CPU: ``pose_data.make_targets`` / ``make_batch``,
``hand_data.make_hand_batch``, ``face_data.landmark_heatmap_targets`` /
``detector_targets`` / ``make_face_batch``, and the fixtures' ``init_tiny``.

``jax.random`` cannot be reproduced, so the batches are compared on
shared draws: the test replays the JAX function's key splits to read the
scenes, noise and jitter it drew, hands them to the port as ``draws=``,
and compares with the JAX function's own output. Tolerances:

- target maps (PAFs, heatmaps, landmark and detector heat) on the same
  scenes: within 1e-5 (the jitted JAX side fuses into FMAs and multiplies
  by reciprocals of constants); the detector's log size within 1e-6;
- renders within 5e-3 of 255 for the hand and the face (as
  ``test_torch_hand.py``: an ulp of a pixel coordinate through a stroke
  edge's slope, times 255; 2.2e-3 seen) and 1e-5 of 1 for the pose
  images (1.1e-6 seen);
- crops within 5e-5 of 1 (the jitted JAX side computes the box with
  FMAs; 6.8e-6 seen); crop-space landmarks ``uv_crop`` within 1e-4 px
  (1.1e-5 seen) and their heatmap targets within 1e-5; AU targets exact;
- ``init_tiny``: the flax tree of each fixture (shapes and names, from
  ``jax.eval_shape`` of the JAX ``init_tiny``) equal to the port's; the
  kernels' standard deviation within 10% of LeCun's and biases 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.models import face_data as jfd
from perception_tpu.models import face_fixture as jff
from perception_tpu.models import hand_data as jhd
from perception_tpu.models import hand_fixture as jhf
from perception_tpu.models import pose_data as jpd
from perception_tpu.models import pose_fixture as jpf
from perception_tpu_torch.convert import au_head_to_flax, face_detector_to_flax, facenet_to_flax, handnet_to_flax, \
    posenet_to_flax
from perception_tpu_torch.models import face_data, face_fixture, hand_data, hand_fixture, pose_data, pose_fixture

torch.set_num_threads(2)


def np_of(x):
    return x.detach().cpu().numpy()


def close(got, want, atol, what):
    np.testing.assert_allclose(np_of(got) if isinstance(got, torch.Tensor) else got, np.asarray(want),
                               rtol=0, atol=atol, err_msg=what)


# --- pose -------------------------------------------------------------------

def jax_pose_draws(key, batch, hw, n_people, pixel_noise):
    """The draws of the JAX ``make_batch(key, ...)``, as ``PoseDraws``."""
    keys = jax.random.split(key, batch)
    scenes = jax.vmap(lambda k: jpd.sample_skeletons(k, hw, n_people))(keys)
    scene = pose_data.SkeletonScene(np.asarray(scenes.joints), np.asarray(scenes.valid))
    if pixel_noise <= 0.0:
        return pose_data.PoseDraws(scene, None, None)
    nk = jax.random.fold_in(key, 7)
    level = np.asarray(jax.random.uniform(nk, (batch, 1, 1, 1))).reshape(batch)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(nk, 1), (batch, *hw, 3)))
    return pose_data.PoseDraws(scene, level, noise)


@pytest.mark.parametrize("pixel_noise", [0.0, 0.1])
def test_make_batch_matches_jax(pixel_noise):
    key, hw, b = jax.random.key(3), (48, 40), 3
    want = jpd.make_batch(key, b, hw, n_people=3, pixel_noise=pixel_noise)
    got = pose_data.make_batch(None, b, hw, n_people=3, pixel_noise=pixel_noise, device="cpu",
                               draws=jax_pose_draws(key, b, hw, 3, pixel_noise))
    close(got["image"].permute(0, 2, 3, 1), want["image"], 1e-5, "image")
    close(got["paf"].permute(0, 2, 3, 1), want["paf"], 1e-5, "paf")
    close(got["heatmap"].permute(0, 2, 3, 1), want["heatmap"], 1e-5, "heatmap")
    assert got["paf"].shape == (b, 28, 6, 5) and got["heatmap"].shape == (b, 16, 6, 5)
    np.testing.assert_array_equal(got["scene"].joints, np.asarray(want["scene"].joints))


def test_make_targets_matches_jax_on_a_scene():
    rng = np.random.default_rng(9)
    scene = pose_data.stack_scenes([pose_data.sample_skeletons(rng, (64, 64), n_people=4) for _ in range(2)])
    want = jax.vmap(lambda j, v: jpd.make_targets(jpd.SkeletonScene(j, v), (8, 8), 8))(
        jnp.asarray(scene.joints), jnp.asarray(scene.valid))
    paf, hm = pose_data.make_targets(torch.from_numpy(scene.joints), torch.from_numpy(scene.valid), (8, 8), 8)
    close(paf.permute(0, 2, 3, 1), want[0], 1e-5, "paf")
    close(hm.permute(0, 2, 3, 1), want[1], 1e-5, "heatmap")
    assert float(hm[:, :15].max()) > 0.5 and float(np.abs(np_of(paf)).max()) > 0.5


# --- hand -------------------------------------------------------------------

def jax_hand_draws(key, batch, hw, pixel_noise):
    joints, scale, noise, jitter, level, pixel = [], [], [], [], [], []
    for k in jax.random.split(key, batch):
        k1, k2, k3 = jax.random.split(k, 3)
        scene = jhd.sample_hand(k1, hw)
        joints.append(np.asarray(scene.joints))
        scale.append(np.asarray(scene.scale))
        noise.append(np.asarray(jax.random.normal(k2, hw)))
        nk = jax.random.fold_in(k2, 7)
        level.append(np.asarray(jax.random.uniform(nk, ())))
        pixel.append(np.asarray(jax.random.normal(jax.random.fold_in(nk, 1), hw)))
        jitter.append(np.asarray(jax.random.uniform(k3, (3,), minval=-1.0, maxval=1.0)))
    s = lambda xs: np.stack(xs).astype(np.float32)
    extra = (s(level), s(pixel)) if pixel_noise > 0.0 else (None, None)
    return hand_data.HandDraws(s(joints), s(scale), s(noise), s(jitter), *extra)


@pytest.mark.parametrize("pixel_noise", [0.0, 0.25])
def test_make_hand_batch_matches_jax(pixel_noise):
    key, b = jax.random.key(5), 3
    want = jhd.make_hand_batch(key, b, pixel_noise=pixel_noise)
    got = hand_data.make_hand_batch(None, b, pixel_noise=pixel_noise, device="cpu",
                                    draws=jax_hand_draws(key, b, (96, 96), pixel_noise))
    close(got["image"], want["image"], 5e-3, "image")
    close(got["uv_crop"], want["uv_crop"], 1e-4, "uv_crop")
    close(got["crop"][:, 0], want["crop"][..., 0], 5e-5, "crop")
    close(got["heatmaps"].permute(0, 2, 3, 1), want["heatmaps"], 1e-5, "heatmaps")
    assert got["crop"].shape == (b, 1, 64, 64) and got["heatmaps"].shape == (b, 21, 16, 16)


# --- face -------------------------------------------------------------------

def jax_face_draws(key, batch, hw, fx, rot_range, pixel_noise):
    scenes, noise, jitter, level, pixel = [], [], [], [], []
    for k in jax.random.split(key, batch):
        k1, k2, k3 = jax.random.split(k, 3)
        scenes.append(jax.tree.map(np.asarray, jfd.sample_face(k1, hw, fx, fx, rot_range=rot_range)))
        noise.append(np.asarray(jax.random.normal(k2, hw)))
        nk = jax.random.fold_in(k2, 7)
        level.append(np.asarray(jax.random.uniform(nk, ())))
        pixel.append(np.asarray(jax.random.normal(jax.random.fold_in(nk, 1), hw)))
        jitter.append(np.asarray(jax.random.uniform(k3, (3,), minval=-1.0, maxval=1.0)))
    scene = face_data.FaceScene(*(np.stack([getattr(sc, f) for sc in scenes]).astype(np.float32)
                                  for f in face_data.FaceScene._fields))
    s = lambda xs: np.stack(xs).astype(np.float32)
    extra = (s(level), s(pixel)) if pixel_noise > 0.0 else (None, None)
    return face_data.FaceDraws(scene, s(noise), s(jitter), *extra)


@pytest.mark.parametrize("pixel_noise", [0.0, 0.12])
def test_make_face_batch_matches_jax(pixel_noise):
    key, b, rot = jax.random.key(6), 2, 0.5
    want = jfd.make_face_batch(key, b, rot_range=rot, pixel_noise=pixel_noise)
    got = face_data.make_face_batch(None, b, rot_range=rot, pixel_noise=pixel_noise, device="cpu",
                                    draws=jax_face_draws(key, b, (128, 128), 300.0, rot, pixel_noise))
    close(got["image"], want["image"], 5e-3, "image")
    close(got["uv_crop"], want["uv_crop"], 1e-4, "uv_crop")
    close(got["crop"][:, 0], want["crop"][..., 0], 5e-5, "crop")
    close(got["heatmaps"].permute(0, 2, 3, 1), want["heatmaps"], 1e-5, "heatmaps")
    np.testing.assert_array_equal(np_of(got["au"]), np.asarray(want["au"]))
    close(got["det_heat"], want["det_heat"], 1e-5, "det_heat")
    close(got["det_size"], want["det_size"], 1e-6, "det_size")
    close(got["det_weight"], want["det_weight"], 1e-5, "det_weight")


def test_face_targets_match_jax():
    rng = np.random.default_rng(2)
    uv = (rng.random((3, 70, 2)) * 96).astype(np.float32)
    want = jax.vmap(lambda u: jfd.landmark_heatmap_targets(u, (24, 24)))(jnp.asarray(uv))
    close(face_data.landmark_heatmap_targets(torch.from_numpy(uv), (24, 24)).permute(0, 2, 3, 1), want, 1e-5, "lm")
    box = np.array([[20.5, 30.25, 80.0, 89.75], [-3.0, 5.0, 60.0, 68.0]], np.float32)
    heat, size, w = face_data.detector_targets(torch.from_numpy(box), (32, 32))
    for i in range(2):
        jh, js, jw = jfd.detector_targets(jnp.asarray(box[i]), (32, 32))
        close(heat[i], jh, 1e-5, "heat")
        close(size[i], js, 1e-6, "logsize")
        close(w[i], jw, 1e-5, "weight")


# --- init_tiny ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["pose", "hand", "face"])
def test_init_tiny_has_the_flax_tree(name):
    jax_init, port_init, to_flax = {
        "pose": (jpf.init_tiny, pose_fixture.init_tiny, posenet_to_flax),
        "hand": (jhf.init_tiny, hand_fixture.init_tiny, handnet_to_flax),
        "face": (jff.init_tiny, face_fixture.init_tiny,
                 lambda n: {"landmark": facenet_to_flax(n["landmark"]), "au": au_head_to_flax(n["au"]),
                            "det": face_detector_to_flax(n["det"])}),
    }[name]
    want = jax.eval_shape(jax_init, jax.random.key(0))
    net = port_init(torch.Generator().manual_seed(0), "cpu")
    assert all(p.requires_grad for p in net.parameters())
    got = to_flax(net)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        label = jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == np.float32, label
        if label.endswith("['bias']"):
            assert not g.any(), label
        elif g.size >= 500:
            lecun = np.sqrt(1.0 / np.prod(g.shape[:-1]))
            assert abs(g.std() / lecun - 1.0) < 0.1, label
