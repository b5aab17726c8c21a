"""TUM RGB-D dataset loading + trajectory file I/O.

Counterpart of ``perception_tpu/io/tum.py``. A sequence directory holds
``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt`` index files (lines
``timestamp path...``, '#' comments), 16-bit PNG depth at 5000
counts/meter and ground-truth lines ``t tx ty tz qx qy qz qw``;
association is nearest timestamps within a tolerance (TUM's
associate.py). Images are read by the port's own PNG codec
(``io/png.py``), which returns what ``cv2.imread`` returns after the JAX
package's BGR -> RGB flip.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from perception_tpu_torch.geometry import se3
from perception_tpu_torch.geometry.camera import PinholeCamera, depth_from_u16
from perception_tpu_torch.io.png import read_png

TUM_DEPTH_SCALE = 1.0 / 5000.0

# Calibrated intrinsics published by the TUM benchmark (ROS default is
# 525/319.5/239.5; fr1/fr2/fr3 are the per-Kinect calibrations).
FR1_K = (517.3, 516.5, 318.6, 255.3)
FR2_K = (520.9, 521.0, 325.1, 249.7)
FR3_K = (535.4, 539.2, 320.1, 247.6)
DEFAULT_K = (525.0, 525.0, 319.5, 239.5)


def tum_camera(freiburg: int = 1) -> PinholeCamera:
    fx, fy, cx, cy = {1: FR1_K, 2: FR2_K, 3: FR3_K}.get(freiburg, DEFAULT_K)
    return PinholeCamera.from_K([fx, 0, cx, 0, fy, cy, 0, 0, 1], width=640, height=480)


def sequence_camera(root, freiburg: int = 1) -> PinholeCamera:
    """Camera for a sequence directory: an optional ``calibration.txt``
    (one line: ``fx fy cx cy width height``) overrides the standard
    Freiburg intrinsics, since the TUM format itself carries none."""
    calib = Path(root) / "calibration.txt"
    if calib.exists():
        for line in calib.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fx, fy, cx, cy, w, h = (float(v) for v in line.split()[:6])
            return PinholeCamera.from_K(
                [fx, 0, cx, 0, fy, cy, 0, 0, 1], width=int(w), height=int(h)
            )
    return tum_camera(freiburg)


def read_file_list(path) -> List[Tuple[float, List[str]]]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1:]))
    return out


def associate(
    a: List[Tuple[float, List[str]]],
    b: List[Tuple[float, List[str]]],
    max_dt: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy closest-timestamp association (TUM associate.py semantics):
    all candidate pairs within max_dt sorted by |dt|, matched greedily
    without reuse."""
    cands = []
    for i, (ta, _) in enumerate(a):
        for j, (tb, _) in enumerate(b):
            dt = abs(ta - (tb + offset))
            if dt < max_dt:
                cands.append((dt, i, j))
    cands.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in cands:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    return pairs


@dataclasses.dataclass
class TumFrame:
    timestamp: float
    depth: np.ndarray              # (H, W) float32 meters, NaN invalid
    rgb: Optional[np.ndarray]      # (H, W, 3) uint8 or None
    gt_pose: Optional[np.ndarray]  # (4, 4) world<-camera or None


def _depth(raw: np.ndarray) -> np.ndarray:
    return depth_from_u16(raw.astype(np.uint16), TUM_DEPTH_SCALE)


def _pose_from_tum(vals: List[str]) -> np.ndarray:
    tx, ty, tz, qx, qy, qz, qw = (float(v) for v in vals[:7])
    R = se3.quat_to_matrix(torch.tensor([qx, qy, qz, qw], dtype=torch.float32)).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = (tx, ty, tz)
    return T


class TumSequence:
    """Lazy frame reader over a TUM sequence directory."""

    def __init__(self, root, with_rgb: bool = True, max_dt: float = 0.02):
        self.root = Path(root)
        self.depth_list = read_file_list(self.root / "depth.txt")
        self.rgb_list = (
            read_file_list(self.root / "rgb.txt")
            if with_rgb and (self.root / "rgb.txt").exists()
            else []
        )
        gt_path = self.root / "groundtruth.txt"
        self.gt_list = read_file_list(gt_path) if gt_path.exists() else []

        self.rgb_of_depth = dict(
            associate(self.depth_list, self.rgb_list, max_dt)
        ) if self.rgb_list else {}
        self.gt_of_depth = dict(
            associate(self.depth_list, self.gt_list, max_dt)
        ) if self.gt_list else {}

    def __len__(self) -> int:
        return len(self.depth_list)

    def frame(self, i: int) -> TumFrame:
        ts, dpath = self.depth_list[i][0], self.depth_list[i][1][0]
        depth = _depth(read_png(self.root / dpath))
        rgb = None
        if i in self.rgb_of_depth:
            rgb = read_png(self.root / self.rgb_list[self.rgb_of_depth[i]][1][0], color=True)
        gt = None
        if i in self.gt_of_depth:
            gt = _pose_from_tum(self.gt_list[self.gt_of_depth[i]][1])
        return TumFrame(timestamp=ts, depth=depth, rgb=rgb, gt_pose=gt)

    def frames(self, start: int = 0, stop: Optional[int] = None, step: int = 1) -> Iterator[TumFrame]:
        for i in range(start, stop if stop is not None else len(self), step):
            yield self.frame(i)


def trajectory_text(timestamps, poses) -> str:
    """TUM-format lines ``t tx ty tz qx qy qz qw``, six decimals, one a pose
    (the quaternion from the rotation in float32)."""
    lines = []
    for t, T in zip(timestamps, poses):
        T = np.asarray(T)
        q = se3.matrix_to_quat(torch.from_numpy(np.array(T[:3, :3], np.float32))).numpy()
        tx, ty, tz = T[:3, 3]
        lines.append(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return "".join(lines)


def write_trajectory(path, timestamps, poses) -> None:
    """Write a TUM-format trajectory (t tx ty tz qx qy qz qw)."""
    Path(path).write_text(trajectory_text(timestamps, poses))


def read_trajectory(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory -> (timestamps (N,), poses (N, 4, 4))."""
    ts, poses = [], []
    for t, vals in read_file_list(Path(path)):
        ts.append(t)
        poses.append(_pose_from_tum(vals))
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))
