"""Example 02 — clustering + multi-object ICP "service".

The reference's `detect_objects` service (object_pose_detection.cpp
service_callback :270-442): passthrough -> voxel -> plane removal (RANSAC,
the K1 kernel on the card) -> Euclidean clustering -> per-cluster
template ICP -> winner by point count. The per-(cluster, restart) ICPs
run as ONE batch on the device instead of a sequential loop with ≤10
restarts.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, generator, host, print_pose, small_camera  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.bench.scene import render_depth_tabletop  # noqa: E402
from perception_tpu_torch.io.templates import cuboid_template  # noqa: E402
from perception_tpu_torch.models.objects import ObjectConfig, detect_object  # noqa: E402


def main(dev=None) -> dict:
    dev = device(dev)
    # Half-resolution D435: the winner gate compares cluster point count
    # against the voxelized template, so the camera must sample the
    # object at roughly the template's density.
    camera = small_camera(width=320, height=240)
    dims = (0.12, 0.05, 0.04)  # an "eraser"-sized object class
    depth = render_depth_tabletop(
        camera, cuboid_pose_twist=(0.04, 0.0, 0.60, 0.0, 0.0, 0.5), dims=dims,
        table_z=0.68,
    )

    pts, mask = camera.backproject_depth(torch.as_tensor(depth, device=dev))

    template_np = cuboid_template(*dims, 0.004)
    template = torch.as_tensor(template_np, device=dev)
    tmask = torch.ones(len(template_np), dtype=torch.bool, device=dev)

    # Param overrides, the way the reference's launch files override the
    # node defaults: the small example camera sees far fewer points
    # than a 640x480 D435.
    config = ObjectConfig(cluster_min_size=60)
    result = detect_object(pts, mask, template, tmask, generator(dev, 0), config)

    sizes = host(result.cluster_sizes)
    print(f"clusters found = {int(result.num_clusters)}  sizes = {sizes[sizes > 0]}")
    print(f"service response: success = {bool(result.success)}  "
          f"(winner slot {int(result.cluster_id)}, size diff {int(result.size_diff)}, "
          f"fitness {float(result.fitness):.2e})")
    print_pose("camera<-object", result.pose)
    assert bool(result.success)
    return {"success": bool(result.success), "num_clusters": int(result.num_clusters),
            "sizes": sizes[sizes > 0].tolist(), "size_diff": int(result.size_diff),
            "fitness": float(result.fitness), "pose": host(result.pose)}


if __name__ == "__main__":
    main()
