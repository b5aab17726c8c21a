"""Example 05 — keyframe SLAM over an RGB-D sequence.

The full stack the reference lacks: per-frame
point-to-plane GN-ICP odometry against the active keyframe, keyframe
spawning by motion thresholds, FAST/BRIEF loop-closure probes, and
pose-graph correction after a closure — with ATE against the known
trajectory (`io/tum.py` loads real TUM RGB-D sequences the same way). K2 and the
voxel hash stay off: keyframe odometry at ``fused_gn="auto"`` runs the
op graph.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.geometry import se3  # noqa: E402
from perception_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from perception_tpu_torch.models.slam.odometry import OdometryConfig  # noqa: E402
from perception_tpu_torch.models.slam.system import SlamConfig, run_slam  # noqa: E402
from perception_tpu_torch.utils.metrics import ate  # noqa: E402


def render_textured_room(camera, T_wc, seed=0):
    """Gray+depth of a textured box room (world-anchored pattern)."""
    H, W = camera.height, camera.width
    fx, fy, cx, cy = (float(camera.fx), float(camera.fy),
                      float(camera.cx), float(camera.cy))
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1)
    T = np.asarray(T_wc, np.float64)
    o, d = T[:3, 3], rays @ T[:3, :3].T
    depth = np.full((H, W), np.inf)
    world = np.zeros((H, W, 3))
    for n, c in [((0, 1.0, 0), 0.9), ((0, -1.0, 0), 0.9), ((0, 0, 1.0), 3.0),
                 ((1.0, 0, 0), 1.3), ((-1.0, 0, 0), 1.3)]:
        n = np.asarray(n)
        denom = d @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c - o @ n) / denom
        t = np.where((t > 0.1) & (denom != 0), t, np.inf)
        z = t * rays[..., 2]
        closer = z < depth
        depth = np.where(closer, z, depth)
        with np.errstate(invalid="ignore"):
            world = np.where(closer[..., None], o + t[..., None] * d, world)
    cells = np.floor(world / 0.12).astype(np.int64)
    h = (cells[..., 0] * 73856093) ^ (cells[..., 1] * 19349663) ^ (cells[..., 2] * 83492791)
    gray = 60.0 + (np.abs(h) % 97) * 1.8
    depth[~np.isfinite(depth)] = 0.0
    rng = np.random.RandomState(seed)
    return gray.astype(np.float32), (depth + rng.randn(H, W) * 5e-4).astype(np.float32)


def main(dev=None) -> dict:
    dev = device(dev)
    camera = PinholeCamera.from_K([60.0, 0, 48, 0, 60.0, 36, 0, 0, 1],
                                  width=96, height=72)
    # Out-and-back trajectory: revisits the start -> loop closure.
    n = 12
    gt = []
    half = (n - 1) / 2
    for k in range(n):
        dist = (k if k <= half else (n - 1 - k)) * (0.35 / half)
        gt.append(se3.se3_exp(
            torch.tensor([dist, 0, 0, 0, 0.02 * np.sin(np.pi * k / (n - 1)), 0],
                         dtype=torch.float32)).numpy())

    grays, depths = zip(*[(g, d) for g, d in
                          (render_textured_room(camera, T, seed=i)
                           for i, T in enumerate(gt))])

    cfg = SlamConfig(
        odometry=OdometryConfig(point_budget=1024, keyframe_budget=2048,
                                icp_iterations=8, min_depth=0.1, max_depth=6.0,
                                normal_max_edge=0.5,
                                kf_translation=0.08, kf_rotation=0.1),
        max_keyframes=16, max_edges=40, features_per_kf=128,
        fast_threshold=15.0, lc_min_gap=2, lc_min_matches=15, lc_min_inliers=8,
    )
    state, poses, diags = run_slam(camera, [torch.as_tensor(d, device=dev) for d in depths],
                                   [torch.as_tensor(g, device=dev) for g in grays], cfg)

    est = np.stack([host(p) for p in poses])
    ref = np.stack(gt)
    result = ate(est, ref)
    print(f"frames = {n}  keyframes = {int(state.keyframes.count)}  "
          f"pose-graph edges = {int(state.edges.count)}")
    print(f"ATE rmse = {result.rmse * 100:.2f} cm  max = {result.max * 100:.2f} cm")
    assert result.rmse < 0.10
    return {"keyframes": int(state.keyframes.count), "edges": int(state.edges.count),
            "ate_rmse": float(result.rmse), "ate_max": float(result.max), "poses": est}


if __name__ == "__main__":
    main()
