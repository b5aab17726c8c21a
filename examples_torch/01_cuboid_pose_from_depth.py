"""Example 01 — cuboid pose from a single depth frame.

The flagship pipeline (the reference's `roslaunch cuboid_detection
iterative_closest_point.launch` flow): depth image -> backproject ->
passthrough -> voxel downsample -> RANSAC ground plane (the K1 kernel on
the card: one launch) -> dominant-cluster extraction -> multi-restart
template ICP -> 6-DoF pose + fitness gate + 8-vertex bounding box.

Everything from backprojection to the accept gate runs on the example's
device without a host sync; the depth frame is the only host->device
transfer per call.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, generator, host, print_pose, small_camera  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.bench.scene import render_depth_tabletop  # noqa: E402
from perception_tpu_torch.io.templates import cuboid_template  # noqa: E402
from perception_tpu_torch.models.cuboid import (  # noqa: E402
    CuboidConfig,
    cuboid_pipeline_from_depth,
    template_features,
)


def main(dev=None) -> dict:
    dev = device(dev)
    camera = small_camera()
    dims = (0.2, 0.1, 0.03)  # the L200_W100_H30 template of the launch file

    # Synthetic tabletop frame with a known ground-truth cuboid pose.
    gt_twist = (0.05, 0.03, 0.80, 0.0, 0.0, 0.3)
    depth = render_depth_tabletop(camera, cuboid_pose_twist=gt_twist, dims=dims)

    # Template prep is host-side and session-constant.
    template_np = cuboid_template(*dims, 0.004)
    config = CuboidConfig()
    template, tnormals, tmask = template_features(template_np, np.ones(len(template_np), bool), config, device=dev)

    result = cuboid_pipeline_from_depth(
        torch.as_tensor(depth, device=dev), camera, template, tmask, generator(dev, 0), config,
        template_normals=tnormals,
    )

    print(f"accepted = {bool(result.accepted)}  "
          f"fitness = {float(result.fitness):.2e} (gate {config.fitness_threshold})")
    print_pose("estimated camera<-cuboid", result.pose)
    bbox_cam = host(result.bbox)
    print("bbox vertex z range: "
          f"[{bbox_cam[:, 2].min():.3f}, {bbox_cam[:, 2].max():.3f}] m")
    assert bool(result.accepted), "fitness gate should accept the synthetic scene"
    return {"accepted": bool(result.accepted), "fitness": float(result.fitness), "pose": host(result.pose),
            "bbox_z": (float(bbox_cam[:, 2].min()), float(bbox_cam[:, 2].max()))}


if __name__ == "__main__":
    main()
