"""Example 08 — camera models, image bridge, and display conversion.

The vision_opencv layer (cv_bridge + image_geometry): pinhole project /
backproject round trip, plumb_bob distortion rectification, stereo
disparity -> 3-D, encoding conversions, and cvtColorForDisplay-style
depth/label visualization, the display images made on the example's
device.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from perception_tpu_torch.geometry.stereo import StereoCamera  # noqa: E402
from perception_tpu_torch.io.imgcodec import (  # noqa: E402
    array_to_image,
    convert_color,
    cvt_color_for_display,
    image_to_array,
)


def main(dev=None) -> dict:
    dev = device(dev)
    cam = PinholeCamera.d435_depth()

    # project . pixel_to_ray == identity (image_geometry's invariant test).
    uv = torch.tensor([[100.0, 80.0], [320.0, 240.0], [613.0, 470.0]], device=dev)
    rays = cam.pixel_to_ray(uv)
    uv2 = cam.project(rays * 2.5)  # any positive depth
    err = float(torch.max(torch.abs(uv2 - uv)))
    print(f"project(pixel_to_ray(uv)) max error = {err:.2e} px")
    assert err < 1e-3

    # Distorted camera: rectifyPoint . unrectifyPoint ~ identity.
    dcam = PinholeCamera.from_K(
        [380.0, 0, 320, 0, 380.0, 240, 0, 0, 1], width=640, height=480,
        dist=[0.1, -0.05, 0.001, 0.001, 0.0],
    )
    pt = torch.tensor([250.0, 200.0], device=dev)
    rt = dcam.rectify_point(dcam.unrectify_point(pt))
    rect_err = float(torch.linalg.norm(rt - pt))
    print(f"rectify(unrectify(pt)) error = {rect_err:.2e} px")

    # Stereo: disparity -> 3-D point (StereoCameraModel Q matrix).
    stereo = StereoCamera(left=cam, baseline=0.05)
    xyz = stereo.project_disparity_to_3d(torch.tensor([300.0, 220.0], device=dev),
                                         torch.tensor(9.5, device=dev))
    print(f"disparity 9.5 px at (300, 220) -> z = {float(xyz[2]):.3f} m")

    # cv_bridge: encode / convert / display.
    rgb = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    msg = array_to_image(rgb, "rgb8")
    back = image_to_array(msg)
    assert (back == rgb).all()
    bgr = convert_color(rgb, "rgb8", "bgr8")
    assert (bgr[..., 0] == rgb[..., 2]).all()

    depth = np.random.RandomState(1).uniform(0.3, 3.0, (48, 64)).astype(np.float32)
    disp = cvt_color_for_display(torch.as_tensor(depth, device=dev), "32FC1", "bgr8", do_dynamic_scaling=True)
    labels = np.arange(48 * 64, dtype=np.int32).reshape(48, 64) % 7 - 1
    lab = cvt_color_for_display(torch.as_tensor(labels, device=dev), "32SC1", "rgb8")
    print(f"display images: depth {tuple(disp.shape)} {disp.dtype}, labels {tuple(lab.shape)}")
    return {"ray_err": err, "rect_err": rect_err, "xyz": host(xyz), "depth_display": host(disp),
            "label_display": host(lab)}


if __name__ == "__main__":
    main()
