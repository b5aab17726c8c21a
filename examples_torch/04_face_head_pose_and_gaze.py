"""Example 04 — face detection -> landmarks -> head pose + gaze.

The openface2_ros flow (openface2_ros.cpp:145-490): detect faces in the
image (MTCNN with Haar/HOG fallback there; the multi-scale Haar-contrast
detector here, no body pose needed), then 68+2 landmarks -> 6-DoF head
pose (GN PnP on a rigid 6-point face model, the GetPose equivalent) ->
per-eye gaze vectors -> detection dedup. The landmarks are synthesized
from a known head pose so the recovered pose can be checked; in the full
pipeline they come from `FaceLandmarkNet` heatmaps via the shared
subpixel NMS decoder.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host, print_pose  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.geometry import se3  # noqa: E402
from perception_tpu_torch.models.face import (  # noqa: E402
    PNP_LANDMARK_IDS,
    PNP_MODEL_POINTS,
    gaze_from_landmarks,
    head_pose_pnp,
    non_overlapping_detections,
)


def render_face(H=120, W=160, cx=80, cy=60, size=40, skin=180.0, bg=100.0, seed=0):
    """Synthetic frontal face: skin ellipse, dark eyes/brows/mouth,
    bright nose bridge, the contrast structure real faces have (the JAX
    tests' ``tests/test_face_detect.render_face``, copied: that module
    imports jax)."""
    rng = np.random.RandomState(seed)
    img = np.full((H, W), bg) + rng.randn(H, W) * 2.0
    yy, xx = np.mgrid[0:H, 0:W].astype(float)

    def ellipse(cx_, cy_, rx, ry):
        return ((xx - cx_) / rx) ** 2 + ((yy - cy_) / ry) ** 2 <= 1.0

    s = size / 24.0  # canonical window units
    img[ellipse(cx, cy, 10.5 * s, 12 * s)] = skin
    # Eyes (dark) at canonical rows ~9-11, cols ~6.5 / 17.5 of 24.
    for ex in (-5.5 * s, 5.5 * s):
        img[ellipse(cx + ex, cy - 2.0 * s, 2.6 * s, 1.5 * s)] = 60.0
        img[ellipse(cx + ex, cy - 4.5 * s, 2.8 * s, 0.7 * s)] = 80.0  # brow
    # Mouth (dark) near canonical row 20.
    img[ellipse(cx, cy + 7.0 * s, 3.5 * s, 1.3 * s)] = 70.0
    # Nose shadowless bridge stays skin-bright.
    gt_box = np.array([cx - 12 * s, cy - 12 * s, cx + 12 * s, cy + 12 * s])
    return img.astype(np.float32), gt_box


def main(dev=None) -> dict:
    dev = device(dev)
    fx = fy = 615.0
    cx, cy = 320.0, 240.0

    # --- image-based face detection (no pose input) --------------------
    from perception_tpu_torch.models.face_detect import detect_faces

    img, gt_box = render_face(H=240, W=320, cx=160, cy=120, size=48)
    dets = detect_faces(torch.as_tensor(img, device=dev))
    got = host(dets.boxes)[host(dets.mask)]
    assert len(got) >= 1, "face detector found nothing"
    b = got[0]
    print(f"detected face box: ({b[0]:.0f},{b[1]:.0f})-({b[2]:.0f},{b[3]:.0f}) "
          f"(gt {gt_box.round(0)})")

    # Ground-truth head pose: 0.7 m out, slight yaw + tilt.
    T_gt = se3.se3_exp(torch.tensor([0.05, -0.02, 0.7, 0.05, 0.3, 0.0])).numpy()

    # Synthesize the 70-landmark array: project the 6 rigid model points
    # into the image at their landmark slots; park the rest near the
    # face center so the gaze ring lookups stay in range.
    pts_cam = PNP_MODEL_POINTS @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv6 = np.stack([fx * pts_cam[:, 0] / pts_cam[:, 2] + cx,
                    fy * pts_cam[:, 1] / pts_cam[:, 2] + cy], -1)
    landmarks = np.full((70, 2), [cx, cy], np.float32)
    landmarks[PNP_LANDMARK_IDS] = uv6
    # Eye rings + pupils (looking slightly right).
    landmarks[36:42] = uv6[2] + np.array([[-8, 0], [-4, -3], [4, -3], [8, 0], [4, 3], [-4, 3]])
    landmarks[42:48] = uv6[3] + np.array([[-8, 0], [-4, -3], [4, -3], [8, 0], [4, 3], [-4, 3]])
    landmarks[68] = uv6[2] + np.array([2.0, 0.0])
    landmarks[69] = uv6[3] + np.array([2.0, 0.0])
    # Landmarks 36/45 are both eye-ring corners AND PnP points: keep
    # their exact projections so the pose solve stays consistent.
    landmarks[PNP_LANDMARK_IDS] = uv6
    lm = torch.as_tensor(landmarks, device=dev)
    lm_mask = torch.ones(70, dtype=torch.bool, device=dev)

    T_est, reproj_err = head_pose_pnp(lm, lm_mask, fx, fy, cx, cy, iterations=40)
    print_pose("camera<-head (estimated)", T_est)
    t_err = float(np.linalg.norm(host(T_est)[:3, 3] - T_gt[:3, 3]))
    print(f"reprojection error = {float(reproj_err):.3f} px, "
          f"translation error vs GT = {t_err * 1000:.1f} mm")
    assert t_err < 0.02 and float(reproj_err) < 1.0

    gaze_r, gaze_l = gaze_from_landmarks(lm, T_est, fx, fy, cx, cy)
    print(f"gaze right = {host(gaze_r).round(3)}  left = {host(gaze_l).round(3)}")

    # Multi-face dedup (NonOverlapingDetections, IoU > 0.5 with a live
    # tracker suppressed): one tracker already covers the first box.
    tracks = torch.tensor([[100.0, 100, 200, 200]], device=dev)
    boxes = torch.tensor([[110.0, 105, 205, 210], [400.0, 80, 470, 160]], device=dev)
    keep = non_overlapping_detections(tracks, torch.ones(1, dtype=torch.bool, device=dev), boxes,
                                      torch.ones(2, dtype=torch.bool, device=dev))
    kept = int(keep.sum())
    print(f"non_overlapping_detections keeps {kept} of 2 detections")
    assert kept == 1
    return {"box": b, "t_err": t_err, "reproj_px": float(reproj_err), "gaze_r": host(gaze_r),
            "gaze_l": host(gaze_l), "kept": kept}


def main_facade(dev=None) -> dict:
    """Same stack via the Perception facade (wrapper.py), the
    Wrapper::configure/exec surface of the reference; face and hands ride
    the trained fixtures when present."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.models import hand_fixture as HF
    from perception_tpu_torch.models import pose_fixture as PF
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructHand,
        WrapperStructInput,
        WrapperStructPose,
    )

    dev = device(dev)
    if not (PF.fixture_available() and FF.fixture_available()
            and HF.fixture_available()):
        print("facade demo skipped (fixtures missing)")
        return {}
    frames = [np.random.RandomState(7).rand(128, 128, 3).astype(np.float32)]
    engine = Perception(
        pose=WrapperStructPose(topology=PF.FIXTURE_TOPOLOGY, net_hw=PF.FIXTURE_HW),
        face=WrapperStructFace(enabled=True),
        hand=WrapperStructHand(enabled=True),
        input=WrapperStructInput(source=frames),
        device=dev,
    )
    out = {}
    for datum in engine.exec():
        # Multi-face facade outputs are (max_faces, ...) slot arrays.
        out = {"people": int(host(datum.people.mask).sum()), "faces": int(host(datum.faces["mask"]).sum()),
               "face_reproj_px": float(host(datum.faces["reproj_px"])[0]),
               "hand_landmarks": int(host(datum.hands["landmark_mask"]).sum())}
        print(f"facade: people={out['people']}, faces={out['faces']}, "
              f"face reproj={out['face_reproj_px']:.2f} px, hand lms={out['hand_landmarks']}")
    return out


if __name__ == "__main__":
    main()
    main_facade()
