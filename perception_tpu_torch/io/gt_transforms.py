"""transforms.txt-style ground-truth pose files.

Counterpart of ``perception_tpu/io/gt_transforms.py``: the reference's
hand-measured TF dump per object (named sections, each a ROS
TransformStamped YAML echo with translation + quaternion), read and
written so synthetic harnesses and real captures share one format.

The quaternion components follow the JAX package exactly, so files
pass between the two packages unchanged: ``save_gt_transforms`` writes
``se3.matrix_to_quat``'s (x, y, z, w) result as if it were (w, x, y, z),
and ``load_gt_transforms`` inverts that. A file written by ROS itself
reads as another rotation in both packages (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import numpy as np

import torch

from perception_tpu_torch.geometry import se3


def save_gt_transforms(
    path,
    poses: Dict[str, np.ndarray],
    frame_id: str = "/camera_depth_optical_frame",
    child_frame_id: str = "/object_frame",
) -> None:
    """Write {name: (4, 4) camera->object pose} in the reference's
    transforms.txt section layout."""
    lines = []
    for name, T in poses.items():
        T = np.asarray(T, np.float64)
        q = se3.matrix_to_quat(torch.from_numpy(np.array(T[:3, :3], np.float32))).numpy()
        t = T[:3, 3]
        lines += [
            f"############# {name} #############",
            "transforms: ",
            "  - ",
            "    header: ",
            "      seq: 0",
            "      stamp: ",
            "        secs: 0",
            "        nsecs: 0",
            f'      frame_id: "{frame_id}"',
            f'    child_frame_id: "{child_frame_id}"',
            "    transform: ",
            "      translation: ",
            f"        x: {t[0]:.10g}",
            f"        y: {t[1]:.10g}",
            f"        z: {t[2]:.10g}",
            "      rotation: ",
            f"        x: {q[1]:.12g}",
            f"        y: {q[2]:.12g}",
            f"        z: {q[3]:.12g}",
            f"        w: {q[0]:.12g}",
            "",
        ]
    Path(path).write_text("\n".join(lines))


def load_gt_transforms(path) -> Dict[str, np.ndarray]:
    """Parse a transforms.txt-style file -> {name: (4, 4) float64 pose}.

    Tolerant of the reference's hand-edited formatting: sections are
    ``##... name ##...`` headers; within a section the first
    translation/rotation blocks are used."""
    text = Path(path).read_text()
    sections = re.split(r"#{2,}\s*([^#\n]+?)\s*#{2,}", text)
    out: Dict[str, np.ndarray] = {}
    # re.split gives [prefix, name1, body1, name2, body2, ...]
    for name, body in zip(sections[1::2], sections[2::2]):
        def grab(block: str, key: str) -> float:
            m = re.search(
                rf"{block}:\s*\n(?:.*\n)*?\s*{key}:\s*([-\d.eE+]+)", body
            )
            if m is None:
                raise ValueError(f"missing {block}.{key} in section {name!r}")
            return float(m.group(1))

        t = np.array(
            [grab("translation", k) for k in ("x", "y", "z")], np.float64
        )
        qx, qy, qz, qw = (grab("rotation", k) for k in ("x", "y", "z", "w"))
        R = se3.quat_to_matrix(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        out[name.strip()] = T
    return out
