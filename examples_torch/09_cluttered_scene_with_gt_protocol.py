"""Example 09 — cluttered 4-class scene, captured templates, GT protocol.

The full object_detection workflow the reference ships as data
(``object_detection/templates/*.pcd`` + ``transforms.txt``): capture an
ICP template per class by rendering the object alone, write the scene's
ground-truth poses in the reference's transforms.txt TF-dump format,
then run the detection service per class (its RANSAC plane removal is
the K1 kernel on the card, one launch a class) on a cluttered tabletop and
check the recovered pose against the GT read back through the protocol.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, generator, host  # noqa: E402

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.bench.clutter_scene import (  # noqa: E402
    captured_template,
    render_depth_clutter,
    standard_clutter_poses,
)
from perception_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from perception_tpu_torch.io.gt_transforms import (  # noqa: E402
    load_gt_transforms,
    save_gt_transforms,
)
from perception_tpu_torch.models.objects import ObjectConfig, detect_object  # noqa: E402


def main(dev=None) -> dict:
    dev = device(dev)
    base = PinholeCamera.d435_depth()
    cam = dataclasses.replace(
        base, fx=base.fx / 2, fy=base.fy / 2, cx=base.cx / 2, cy=base.cy / 2,
        width=320, height=240,
    )

    poses = standard_clutter_poses()
    with tempfile.TemporaryDirectory() as d:
        gt_path = Path(d) / "transforms.txt"
        save_gt_transforms(gt_path, poses)
        gt = load_gt_transforms(gt_path)
    print(f"GT protocol round-trip: {len(gt)} objects")

    depth = render_depth_clutter(cam, poses, seed=3)
    pts, mask = cam.backproject_depth(torch.as_tensor(depth, device=dev))
    cfg = ObjectConfig(cluster_min_size=12, cluster_capacity=1024,
                       ransac_hypotheses=256, icp_restarts=3,
                       icp_max_iterations=40, size_gate=120)

    ok = 0
    per_class = {}
    for name in sorted(gt):
        tmpl_np = captured_template(name, cam)
        tmpl = torch.as_tensor(tmpl_np, device=dev)
        res = detect_object(pts, mask, tmpl, torch.ones(len(tmpl), dtype=torch.bool, device=dev),
                            generator(dev, 0), cfg)
        est = host(res.pose)
        a = tmpl_np @ est[:3, :3].T + est[:3, 3]
        b = tmpl_np @ gt[name][:3, :3].T + gt[name][:3, 3]
        # symmetric-safe pose error: mean NN distance between the
        # template under the estimated vs GT pose
        d2 = ((a[:, None, :] - b[None, ::7, :]) ** 2).sum(-1)
        err_cm = float(np.sqrt(d2.min(1)).mean() * 100)
        print(f"{name:12s} success={bool(res.success)} "
              f"pose-chamfer={err_cm:.2f} cm "
              f"clusters={int(res.num_clusters)}")
        ok += bool(res.success) and err_cm < 1.5
        per_class[name] = {"success": bool(res.success), "chamfer_cm": err_cm,
                           "num_clusters": int(res.num_clusters)}
    assert ok >= 3, f"only {ok}/4 classes recovered"
    print(f"recovered {ok}/4 classes within 1.5 cm")
    return {"recovered": ok, "classes": per_class}


if __name__ == "__main__":
    main()
