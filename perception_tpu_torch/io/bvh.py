"""BVH motion-capture export of tracked skeletons.

A numpy copy of ``perception_tpu/io/bvh.py``, so that both packages
write the same text. Equivalent of OpenPose's ``BvhSaver`` (filestream
module): writes a HIERARCHY built from a topology's limb tree plus a MOTION block of
per-frame root translation + per-joint Euler rotations. Input is the
per-frame 3-D keypoints (camera/world frame, meters); joint rotations
are derived per frame by aligning each limb's rest direction to its
observed direction (the minimal-twist rotation).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _build_tree(pairs: np.ndarray, root: int) -> Dict[int, List[int]]:
    children: Dict[int, List[int]] = {}
    seen = {root}
    frontier = [root]
    pairs_l = [tuple(p) for p in np.asarray(pairs)]
    while frontier:
        nxt = []
        for node in frontier:
            for a, b in pairs_l:
                if a == node and b not in seen:
                    children.setdefault(node, []).append(b)
                    seen.add(b)
                    nxt.append(b)
                elif b == node and a not in seen:
                    children.setdefault(node, []).append(a)
                    seen.add(a)
                    nxt.append(a)
        frontier = nxt
    return children


def _rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-9:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1 + c)


def _euler_zxy(R: np.ndarray) -> Tuple[float, float, float]:
    """BVH-convention Z X Y Euler angles (degrees)."""
    x = np.arcsin(np.clip(R[2, 1], -1, 1))
    z = np.arctan2(-R[0, 1], R[1, 1])
    y = np.arctan2(-R[2, 0], R[2, 2])
    return tuple(np.degrees([z, x, y]))


def save_bvh(
    path,
    keypoints_frames: Sequence[np.ndarray],  # list of (P, 3) per frame
    pairs: np.ndarray,
    part_names: Sequence[str],
    root: int = 8,          # BODY_25 MidHip
    fps: float = 30.0,
    scale: float = 100.0,   # meters -> BVH centimeters
) -> None:
    frames = [np.asarray(f, np.float64) for f in keypoints_frames]
    rest = frames[0]
    tree = _build_tree(pairs, root)

    joint_order: List[int] = []

    def hier(node: int, depth: int, lines: List[str]):
        joint_order.append(node)
        pad = "  " * depth
        tag = "ROOT" if depth == 0 else "JOINT"
        off = (rest[node] - (rest[node] if depth == 0 else rest[_parent[node]])) * scale
        lines.append(f"{pad}{tag} {part_names[node].replace(' ', '_')}")
        lines.append(pad + "{")
        lines.append(f"{pad}  OFFSET {off[0]:.4f} {off[1]:.4f} {off[2]:.4f}")
        ch = "CHANNELS 6 Xposition Yposition Zposition Zrotation Xrotation Yrotation" if depth == 0 \
            else "CHANNELS 3 Zrotation Xrotation Yrotation"
        lines.append(f"{pad}  {ch}")
        kids = tree.get(node, [])
        if not kids:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.0 0.0 0.0")
            lines.append(pad + "  }")
        for k in kids:
            hier(k, depth + 1, lines)
        lines.append(pad + "}")

    _parent = {root: root}
    stack = [root]
    while stack:
        n = stack.pop()
        for k in tree.get(n, []):
            _parent[k] = n
            stack.append(k)

    lines = ["HIERARCHY"]
    hier(root, 0, lines)
    lines.append("MOTION")
    lines.append(f"Frames: {len(frames)}")
    lines.append(f"Frame Time: {1.0 / fps:.6f}")

    for f in frames:
        vals: List[float] = []
        rootpos = f[root] * scale
        vals.extend(rootpos.tolist())
        for node in joint_order:
            kids = tree.get(node, [])
            if kids:
                k = kids[0]
                rest_dir = rest[k] - rest[node]
                cur_dir = f[k] - f[node]
                nr = np.linalg.norm(rest_dir)
                nc = np.linalg.norm(cur_dir)
                if nr > 1e-9 and nc > 1e-9:
                    R = _rot_between(rest_dir / nr, cur_dir / nc)
                else:
                    R = np.eye(3)
            else:
                R = np.eye(3)
            vals.extend(_euler_zxy(R))
        lines.append(" ".join(f"{v:.4f}" for v in vals))

    Path(path).write_text("\n".join(lines))
