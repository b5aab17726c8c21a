"""2-D red-object detector: the reference's colour pipeline on tensors.

Counterpart of ``perception_tpu/models/color_detect.py``, which replicates
``cuboid_detection/scripts/object_detection.py:25-76``: the dual-range
red HSV threshold ([0,50,100]-[10,255,255] union [175,50,100]-[180,255,255]),
5x5 erode x2 + dilate x2, the largest component, its bounding rect and a
+/-10 px margin -> Rectangle(x1, y1, x2, y2). Runs on the image's device
with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perception_tpu_torch.ops.image import (
    dilate,
    erode,
    in_range,
    largest_component_bbox,
    rgb_to_hsv_cv,
)

LOWER_RED1 = (0.0, 50.0, 100.0)
UPPER_RED1 = (10.0, 255.0, 255.0)
LOWER_RED2 = (175.0, 50.0, 100.0)
UPPER_RED2 = (180.0, 255.0, 255.0)
MARGIN = 10  # the 'd' pixel margin (object_detection.py:63)


class Rectangle(NamedTuple):
    """Mirror of the reference's Rectangle.msg (x1, y1, x2, y2), int32."""

    x1: torch.Tensor
    y1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    valid: torch.Tensor  # () bool: detection found (the reference crashes on none)


def red_mask(rgb: torch.Tensor) -> torch.Tensor:
    """The post-morphology segmentation mask (the debug image the
    reference publishes on ``/object_detection/image_segmented``)."""
    hsv = rgb_to_hsv_cv(rgb)
    mask = in_range(hsv, LOWER_RED1, UPPER_RED1) | in_range(hsv, LOWER_RED2, UPPER_RED2)
    mask = erode(mask, 5, iterations=2)
    return dilate(mask, 5, iterations=2)


def detect_red_object(rgb: torch.Tensor) -> Rectangle:
    """RGB (H, W, 3) -> Rectangle around the largest red blob."""
    bb = largest_component_bbox(red_mask(rgb))
    return Rectangle(
        x1=bb.x1 - MARGIN,
        y1=bb.y1 - MARGIN,
        x2=bb.x2 + MARGIN,
        y2=bb.y2 + MARGIN,
        valid=bb.valid,
    )
