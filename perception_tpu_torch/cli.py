"""Command-line entry point of the port.

Counterpart of ``perception_tpu/cli.py``, with its subcommands, flags,
defaults and JSON keys:

  python -m perception_tpu_torch.cli cuboid   --depth f.png [--template t.pcd]
  python -m perception_tpu_torch.cli objects  --depth f.png --template t.pcd
  python -m perception_tpu_torch.cli odometry --tum DIR [--out traj.txt]
  python -m perception_tpu_torch.cli slam     [--tum DIR] [--out traj.txt]
  python -m perception_tpu_torch.cli pose     [--image f.png] [--out-json people.json]

Each command prints JSON lines. Everything runs on the CUDA card unless
``--cpu`` is given; with no card and no ``--cpu`` the command stops with
a message. ``--seed`` seeds a ``torch.Generator`` on the run's device (the
RANSAC hypotheses of ``cuboid`` and ``objects``) or, for ``pose``'s
synthetic scene, numpy's ``default_rng``; the streams differ from JAX's,
so results agree with the JAX CLI's, not bit for bit. Images are read by
the port's PNG codec (``io/png.py``); ``pose --image`` in another format
imports ``cv2`` on use. Templates are read by the native PCD reader
(``runtime.read_pcd_native``), TUM sequences frame by frame through
``io/tum.py``. The JAX CLI's ``bench``
runs the JAX package's benchmark and has no counterpart here yet.
"""

from __future__ import annotations

import argparse
import json
import zlib

import numpy as np
import torch


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("perception_tpu_torch.cli: no CUDA card is available; "
                         "pass --cpu to run on the CPU")
    return torch.device("cuda")


def _read_image(path: str, color: bool) -> np.ndarray:
    """A PNG through the port's codec; any other format, and the PNG kinds
    the codec refuses, through cv2 (RGB order), imported on use. Stops
    with the file's name where it needs cv2 and cv2 is missing."""
    from perception_tpu_torch.io import png

    with open(path, "rb") as f:
        is_png = f.read(8) == png.SIGNATURE
    if is_png:
        try:
            return png.read_png(path, color=color)
        except (ValueError, zlib.error):
            pass
    try:
        import cv2
    except ImportError:
        raise SystemExit(f"cannot read image {path}: io/png does not read it and cv2 is not installed") from None

    img = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED)
    if img is None:
        raise SystemExit(f"cannot read image {path}")
    return img[..., ::-1] if img.ndim == 3 else img


def _load_depth(path: str, scale: float) -> np.ndarray:
    from perception_tpu_torch.geometry.camera import depth_from_u16

    try:
        raw = _read_image(path, color=False)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read depth image {path}: {e}") from e
    if raw.dtype == np.uint16:
        return depth_from_u16(raw, scale)
    return raw.astype(np.float32)


def _camera(args):
    from perception_tpu_torch.geometry.camera import PinholeCamera

    if args.camera == "d435-depth":
        return PinholeCamera.d435_depth()
    if args.camera == "d435-color":
        return PinholeCamera.d435_color()
    if args.camera.startswith("tum"):
        from perception_tpu_torch.io.tum import tum_camera

        return tum_camera(int(args.camera[-1]) if args.camera[-1].isdigit() else 1)
    raise SystemExit(f"unknown camera model {args.camera}")


def _generator(args, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(args.seed)


def cmd_cuboid(args) -> None:
    from perception_tpu_torch.io.templates import cuboid_template
    from perception_tpu_torch.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_from_depth,
        template_features,
    )
    from perception_tpu_torch.runtime import read_pcd_native

    device = _device(args)
    camera = _camera(args)
    config = CuboidConfig(
        voxel_size=args.voxel_size,
        ransac_threshold=args.distance_threshold,
        fitness_threshold=args.icp_fitness_score,
    )
    tmpl = read_pcd_native(args.template) if args.template else cuboid_template(*config.dims)
    t, tn, tm = template_features(tmpl, np.ones(len(tmpl), bool), config, device=device)
    depth = torch.from_numpy(_load_depth(args.depth, args.depth_scale)).to(device)
    res = cuboid_pipeline_from_depth(depth, camera, t, tm, _generator(args, device), config,
                                     template_normals=tn)
    res = type(res)(*(x.cpu() for x in res))
    print(json.dumps({
        "accepted": bool(res.accepted),
        "fitness": float(res.fitness),
        "pose": res.pose.numpy().tolist(),
        "plane": res.plane.numpy().tolist(),
        "num_box_points": int(res.num_box_points),
        "bbox": res.bbox.numpy().tolist(),
    }))


def cmd_objects(args) -> None:
    from perception_tpu_torch.models.objects import ObjectConfig, detect_object
    from perception_tpu_torch.runtime import read_pcd_native

    device = _device(args)
    camera = _camera(args)
    tmpl = torch.from_numpy(read_pcd_native(args.template)).to(device)
    depth = torch.from_numpy(_load_depth(args.depth, args.depth_scale)).to(device)
    pts, mask = camera.backproject_depth(depth)
    res = detect_object(
        pts, mask, tmpl, torch.ones(len(tmpl), dtype=torch.bool, device=device),
        _generator(args, device), ObjectConfig(),
    )
    res = type(res)(*(x.cpu() for x in res))
    print(json.dumps({
        "success": bool(res.success),
        "pose": res.pose.numpy().tolist(),
        "fitness": float(res.fitness),
        "num_clusters": int(res.num_clusters),
        "cluster_sizes": res.cluster_sizes.numpy().tolist(),
        "size_diff": int(res.size_diff),
    }))


def _depth_tensor(frame, device) -> torch.Tensor:
    return torch.from_numpy(np.nan_to_num(frame.depth)).to(device)


def cmd_odometry(args) -> None:
    from perception_tpu_torch.io.tum import TumSequence, sequence_camera, write_trajectory
    from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step
    from perception_tpu_torch.utils.metrics import ate
    from perception_tpu_torch.utils.profiler import MetricsLog

    device = _device(args)
    seq = TumSequence(args.tum, with_rgb=False)
    camera = sequence_camera(args.tum, args.freiburg)
    cfg = OdometryConfig()
    log = MetricsLog()

    frames = list(range(0, min(len(seq), args.max_frames), args.stride))
    f0 = seq.frame(frames[0])
    state = init_state(camera, _depth_tensor(f0, device), cfg)
    poses, gts, ts = [np.eye(4)], [f0.gt_pose], [f0.timestamp]
    for i in frames[1:]:
        fr = seq.frame(i)
        state, diag = odometry_step(state, _depth_tensor(fr, device), camera, cfg)
        # One host read a frame: the pose and the three diagnostics.
        row = torch.cat([state.pose.reshape(-1), diag.fitness.reshape(1), diag.overlap.reshape(1),
                         diag.promoted.to(torch.float32).reshape(1)]).cpu().numpy()
        poses.append(row[:16].reshape(4, 4))
        gts.append(fr.gt_pose)
        ts.append(fr.timestamp)
        log.emit(frame=i, fitness=float(row[16]), overlap=float(row[17]), promoted=bool(row[18]))

    if args.out:
        write_trajectory(args.out, ts, poses)
    if all(g is not None for g in gts):
        r = ate(np.stack(poses), np.stack(gts))
        log.emit(metric="ate_rmse_m", value=r.rmse, frames=len(poses))


def cmd_slam(args) -> None:
    """Full SLAM (odometry + keyframes + loop closure + pose graph): over
    a TUM sequence, or the synthetic revisit benchmark when no --tum is
    given."""
    from perception_tpu_torch.utils.profiler import MetricsLog

    device = _device(args)
    log = MetricsLog()
    if args.tum is None:
        from perception_tpu_torch.bench.slam_bench import run as run_slam_bench

        out = run_slam_bench(frames=args.max_frames, device=device)
        log.emit(**{k: v for k, v in out.items() if np.isscalar(v)})
        return

    from perception_tpu_torch.io.tum import TumSequence, sequence_camera, write_trajectory
    from perception_tpu_torch.models.slam.system import SlamConfig, run_slam
    from perception_tpu_torch.utils.metrics import ate

    seq = TumSequence(args.tum, with_rgb=True)
    camera = sequence_camera(args.tum, args.freiburg)
    idxs = list(range(0, min(len(seq), args.max_frames), args.stride))
    frames = [seq.frame(i) for i in idxs]
    depths = [np.nan_to_num(f.depth) for f in frames]
    # Keep gray on the 0-255 scale: SlamConfig.fast_threshold (FAST
    # corner contrast) is calibrated for 8-bit intensities.
    grays = [
        f.rgb.mean(-1).astype(np.float32)
        if f.rgb is not None else np.zeros_like(depths[0])
        for f in frames
    ]
    cfg = SlamConfig()
    state, poses, diags = run_slam(camera, [torch.from_numpy(d).to(device) for d in depths],
                                   [torch.from_numpy(g).to(device) for g in grays], cfg)
    poses = torch.stack(poses).cpu().numpy()
    if args.out:
        write_trajectory(args.out, [f.timestamp for f in frames], poses)
    gts = [f.gt_pose for f in frames]
    if all(g is not None for g in gts):
        r = ate(poses.astype(np.float64), np.stack(gts))
        closures = 0
        if diags:
            cand = torch.stack([d.loop_candidate for d in diags])
            inliers = torch.stack([d.loop_inliers for d in diags])
            closures = int(((cand >= 0) & (inliers >= cfg.lc_min_inliers)).sum())
        log.emit(metric="ate_rmse_m", value=r.rmse, frames=len(poses),
                 loop_closures=closures)


def cmd_pose(args) -> None:
    """Multi-person 2-D pose through the Perception facade (wrapper.py),
    with the repo's trained fixture (or a synthetic scene when no
    --image is given)."""
    from perception_tpu_torch.models.pose_fixture import (
        FIXTURE_HW,
        FIXTURE_TOPOLOGY,
        fixture_available,
    )
    from perception_tpu_torch.utils.profiler import MetricsLog
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructInput,
        WrapperStructPose,
    )

    device = _device(args)
    log = MetricsLog()
    if not fixture_available():
        raise SystemExit("trained fixture missing; run tools/train_pose_fixture.py")
    if args.image:
        try:
            img = _read_image(args.image, color=True).astype(np.float32) / 255.0
        except OSError as e:
            raise SystemExit(f"cannot read image {args.image}: {e}") from e
    else:
        from perception_tpu_torch.models.pose_data import render_people, sample_skeletons

        scene = sample_skeletons(np.random.default_rng(args.seed), FIXTURE_HW)
        img = render_people(scene, FIXTURE_HW)

    # --out-json is written once, explicitly, below (a json_dir sink
    # here would duplicate the same data into a derived directory).
    engine = Perception(
        pose=WrapperStructPose(topology=FIXTURE_TOPOLOGY, net_hw=FIXTURE_HW),
        input=WrapperStructInput(source=[img]),
        device=device,
    )
    for datum in engine.exec():
        ppl = datum.people
        mask = ppl.mask.cpu().numpy()
        n = int(mask.sum())
        log.emit(people=n,
                 scores=[round(float(s), 3) for s in ppl.score.cpu().numpy()[:n]])
        if args.out_json:
            from perception_tpu_torch.io.savers import save_people_json

            save_people_json(args.out_json, ppl.keypoints.cpu().numpy(), mask)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="perception_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--camera", default="d435-depth")
    common.add_argument("--depth-scale", type=float, default=0.001,
                        help="meters per depth unit for u16 PNGs (RealSense 0.001, TUM 0.0002)")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")

    c = sub.add_parser("cuboid", parents=[common], help="ground-plane seg + template ICP pose")
    c.add_argument("--depth", required=True)
    c.add_argument("--template", default=None, help=".pcd template (default: generated L200 W100 H30)")
    c.add_argument("--voxel-size", type=float, default=0.005)
    c.add_argument("--distance-threshold", type=float, default=0.015)
    c.add_argument("--icp-fitness-score", type=float, default=0.0004)
    c.set_defaults(fn=cmd_cuboid)

    o = sub.add_parser("objects", parents=[common], help="clustering + multi-object ICP service")
    o.add_argument("--depth", required=True)
    o.add_argument("--template", required=True)
    o.set_defaults(fn=cmd_objects)

    tum = argparse.ArgumentParser(add_help=False)
    tum.add_argument("--freiburg", type=int, default=1)
    tum.add_argument("--stride", type=int, default=1)
    tum.add_argument("--out", default=None, help="write TUM-format trajectory")

    d = sub.add_parser("odometry", parents=[common, tum], help="TUM depth odometry + ATE")
    d.add_argument("--tum", required=True, help="TUM sequence directory")
    d.add_argument("--max-frames", type=int, default=200)
    d.set_defaults(fn=cmd_odometry)

    s = sub.add_parser("slam", parents=[common, tum],
                       help="full SLAM (odometry+loop closure+pose graph) + ATE")
    s.add_argument("--tum", default=None, help="TUM sequence dir (default: synthetic revisit)")
    s.add_argument("--max-frames", type=int, default=300)
    s.set_defaults(fn=cmd_slam)

    po = sub.add_parser("pose", parents=[common],
                        help="multi-person 2-D pose (trained fixture)")
    po.add_argument("--image", default=None, help="RGB image (default: synthetic scene)")
    po.add_argument("--out-json", default=None, help="write OpenPose-style people JSON")
    po.set_defaults(fn=cmd_pose)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
