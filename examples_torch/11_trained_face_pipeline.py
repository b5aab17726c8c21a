"""Example 11 — the fully TRAINED face stack from raw pixels.

Where example 04 synthesizes landmarks from a known pose to demo the
geometry, this one runs the complete learned pipeline on a rendered
image with the in-repo-trained fixture
(tests/fixtures/facenet_tiny.msgpack, tools_torch/train_face_fixture.py):

  pixels -> FaceDetectorNet (center heatmap, the MTCNN analog)
         -> crop -> FaceLandmarkNet (70 heatmaps) -> decode
         -> head-pose PnP -> gaze rays -> ActionUnitHead -> AU02 gate

the openface2_ros topology end to end (openface2_ros.cpp:198-490), with
no ground-truth inputs anywhere in the pipeline. The three scenes and
their pixel noise are the JAX example's (``fold_in(key(0), i)``, drawn by
``utils/jax_random``).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.utils import jax_random  # noqa: E402


def main(dev=None) -> dict:
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models.face import (
        au_gated_pose_mask,
        gaze_from_landmarks,
        head_pose_pnp,
        normalize_landmarks,
    )
    from perception_tpu_torch.models.face_data import render_face, sample_face_from_key
    from perception_tpu_torch.models.hand import crop_image

    dev = device(dev)
    if not FF.fixture_available():
        print("face fixture missing — run tools_torch/train_face_fixture.py")
        return {}

    params = FF.load_fixture(dev)
    hw = FF.FIXTURE_HW
    fx = FF.FIXTURE_FX
    cx, cy = hw[1] / 2.0, hw[0] / 2.0

    faces = []
    for i in range(3):
        k1, k2 = jax_random.split(jax_random.fold_in(jax_random.key(0), i))
        scene = sample_face_from_key(k1, hw, fx, fx)
        img = torch.as_tensor(render_face(scene, hw, noise=jax_random.normal(k2, hw)), device=dev)

        det = FF.detect_with_net(params["det"], img)
        assert bool(det.mask[0]), "trained detector found no face"
        box = det.boxes[0]
        patch = crop_image(img, box, FF.FIXTURE_CROP) / 255.0
        uv, m, _ = FF.landmarks_from_crop(params["landmark"], patch, box)
        T, px_err = head_pose_pnp(uv, m, fx, fx, cx, cy)
        gaze_r, gaze_l = gaze_from_landmarks(uv, T, fx, fx, cx, cy)
        with torch.no_grad():
            inten, _ = params["au"](normalize_landmarks(uv, m))
        gate = bool(au_gated_pose_mask(inten))

        T_h, uv_h, m_h = host(T), host(uv), host(m)
        t_err = float(np.linalg.norm(T_h[:3, 3] - scene.pose[:3, 3]))
        lm_err = float(np.mean(np.where(m_h, np.linalg.norm(uv_h - scene.landmarks2d, axis=-1), 0.0)))
        print(
            f"face {i}: {int(m_h.sum())}/70 landmarks (err {lm_err:.2f} px), "
            f"head at {np.round(T_h[:3, 3], 3)} "
            f"(gt err {t_err*100:.1f} cm, reproj {float(px_err):.2f} px), "
            f"gaze_z ({float(gaze_r[2]):+.2f}, {float(gaze_l[2]):+.2f}), "
            f"AU02 {float(inten[1]):.2f} -> publish={gate} "
            f"(brow raise gt {float(scene.au02):.2f})"
        )
        assert t_err < 0.05
        assert gate == (float(scene.au02) > 0.4)
        faces.append({"box": host(box), "landmarks": uv_h, "lm_err": lm_err, "t_err": t_err,
                      "reproj_px": float(px_err), "au02": float(inten[1]), "gate": gate, "pose": T_h})
    print("ok")
    return {"faces": faces}


def main_facade(dev=None) -> dict:
    """The trained face pipeline through the Perception facade."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructPose,
    )

    dev = device(dev)
    if not FF.fixture_available():
        print("facade demo skipped (face fixture missing)")
        return {}
    engine = Perception(pose=WrapperStructPose(enabled=False),
                        face=WrapperStructFace(enabled=True), device=dev)
    img = np.random.RandomState(3).rand(128, 128, 3).astype(np.float32) * 255
    datum = engine.emplace_and_pop(img)
    # Slot 0 of the (max_faces, ...) multi-face outputs.
    reproj = float(host(datum.faces["reproj_px"])[0])
    au02 = float(host(datum.faces["au_intensities"])[0, 1])
    print(f"facade face: reproj {reproj:.2f} px, AU02 {au02:.2f}")
    return {"facade_reproj_px": reproj, "facade_au02": au02}


if __name__ == "__main__":
    main()
    main_facade()
