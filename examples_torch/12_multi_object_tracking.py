"""Example 12 — streaming multi-cuboid ICP tracking (config #2).

The cuboid_detection bag-replay topology: a moving camera streams depth
of a table with three differently-sized cuboids; each frame runs plane
segmentation (RANSAC: the K1 kernel on the card, one launch a frame) + Euclidean clustering + per-slot warm-started ICP with
the reference's ICP_SUCCESS latch semantics
(iterative_closest_point.cpp:139-147) — latched tracks republish their
cached pose on a failed solve and re-enter detection after max_misses.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, generator, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(dev=None) -> dict:
    from perception_tpu_torch.bench.tracking_scene import (
        CUBOID_SET,
        camera_trajectory,
        render_depth_cuboids,
    )
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.io.templates import cuboid_template
    from perception_tpu_torch.models.object_tracking import (
        TrackingConfig,
        init_tracks,
        track_step_from_depth,
    )
    from perception_tpu_torch.models.objects import ObjectConfig

    dev = device(dev)

    camera = PinholeCamera.from_K(
        [192.0, 0, 160, 0, 192.0, 120, 0, 0, 1], width=320, height=240
    )
    K = len(CUBOID_SET)
    tmpls = [cuboid_template(*dims, density=0.004) for dims, _ in CUBOID_SET]
    Nt = max(len(t) for t in tmpls)
    templates = np.zeros((K, Nt, 3), np.float32)
    tmasks = np.zeros((K, Nt), bool)
    for k, t in enumerate(tmpls):
        templates[k, : len(t)] = t
        tmasks[k, : len(t)] = True

    cfg = TrackingConfig(
        detection=ObjectConfig(
            cluster_min_size=60, work_capacity=16384, table_z_cut=0.9,
            z_limits=(0.0, 0.9), x_limits=(-0.35, 0.35),
        ),
        max_tracks=K,
    )
    slots = init_tracks(cfg, device=dev)
    gen = generator(dev, 0)  # the RANSAC triplets' stream, one draw a frame
    templates_t, tmasks_t = torch.as_tensor(templates, device=dev), torch.as_tensor(tmasks, device=dev)
    traj = camera_trajectory(10)
    for i, Twc in enumerate(traj):
        depth, gt = render_depth_cuboids(camera, Twc, seed=i)
        slots, diag = track_step_from_depth(
            slots, torch.as_tensor(depth, device=dev), camera, templates_t, tmasks_t, gen, cfg,
        )
        lat = host(slots.latched)
        poses = host(slots.pose)
        errs = [
            np.linalg.norm(poses[k][:3, 3] - gt[k][:3, 3])
            for k in range(K)
        ]
        print(
            f"frame {i}: clusters={int(diag.num_clusters)} "
            f"latched={lat.tolist()} warm={host(diag.used_warm).tolist()} "
            f"pose err cm={[round(e * 100, 1) for e in errs]}"
        )
    assert bool(np.all(lat)), "not all objects tracked"
    assert max(errs) < 0.04, errs
    print("ok")
    return {"latched": lat.tolist(), "errors_m": [float(e) for e in errs], "poses": poses}


if __name__ == "__main__":
    main()
