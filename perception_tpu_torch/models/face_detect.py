"""Image-based face detection (no body pose required).

Counterpart of ``perception_tpu/models/face_detect.py``:

* ``detect_faces``: the dense multi-scale Haar-contrast detector. Every
  pyramid level (antialiased ``bilinear_resize``) scores the 24x24 window
  at every pixel from two integral images, keeps its local peaks
  (``nms_heatmap``), and the peaks of all levels go through greedy IoU
  suppression;
* ``FaceDetectorNet``: the anchor-free centre-heatmap CNN, with flax's
  ``SAME`` padding for its stride-2 convolutions, and
  ``decode_detector_net``.

The integral images are summed in float64 and rounded to float32 once,
so they are the correctly rounded prefix sums on the CPU and the card
alike; XLA's cumulative sum (a reduce-window rewritten as a tree) is
within an ulp of them. Nothing here reads the card back.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perception_tpu_torch._tensor import fp32
from perception_tpu_torch.ops.heatmap import nms_heatmap
from perception_tpu_torch.ops.image import bilinear_resize

# 24x24 canonical window layout (Viola-Jones convention): row bands.
_WIN = 24
_FOREHEAD = (2, 7)    # y0, y1
_EYES = (7, 13)
_MIDFACE = (13, 18)
_MOUTH = (18, 23)
_LEFT_EYE_X = (3, 10)
_RIGHT_EYE_X = (14, 21)
_BRIDGE_X = (10, 14)
_FACE_X = (3, 21)


class FaceDetections(NamedTuple):
    boxes: torch.Tensor   # (K, 4) x1, y1, x2, y2 in input pixels
    scores: torch.Tensor  # (K,)
    mask: torch.Tensor    # (K,)


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Zero-padded integral image of (..., H, W): ii[y, x] = sum(img[:y, :x])."""
    ii = torch.cumsum(torch.cumsum(img.double(), dim=-2), dim=-1).to(img.dtype)
    return F.pad(ii, (1, 0, 1, 0))


def _box_mean(ii: torch.Tensor, y0: int, y1: int, x0: int, x1: int, out_h: int, out_w: int) -> torch.Tensor:
    """Mean of the window-relative box (y0:y1, x0:x1) at every window
    position, (..., out_h, out_w); the division by the box's area is a
    multiply by its reciprocal, as XLA compiles a division by a constant."""
    s = (
        ii[..., y1:y1 + out_h, x1:x1 + out_w]
        - ii[..., y0:y0 + out_h, x1:x1 + out_w]
        - ii[..., y1:y1 + out_h, x0:x0 + out_w]
        + ii[..., y0:y0 + out_h, x0:x0 + out_w]
    )
    return s * (1.0 / ((y1 - y0) * (x1 - x0)))


def _level_scores(gray: torch.Tensor) -> torch.Tensor:
    """Face-contrast score of the 24x24 window anchored at every pixel,
    (H-23, W-23); -1e9 where the window is flat (std <= 4)."""
    iis = _integral(torch.stack([gray, gray * gray]))
    ii, ii2 = iis[0], iis[1]
    H, W = gray.shape
    oh, ow = H - _WIN + 1, W - _WIN + 1

    mean = _box_mean(ii, 0, _WIN, 0, _WIN, oh, ow)
    mean2 = _box_mean(ii2, 0, _WIN, 0, _WIN, oh, ow)
    std = torch.sqrt(torch.clamp(mean2 - mean * mean, min=1e-6))

    forehead = _box_mean(ii, *_FOREHEAD, *_FACE_X, oh, ow)
    midface = _box_mean(ii, *_MIDFACE, *_FACE_X, oh, ow)
    mouth = _box_mean(ii, *_MOUTH, 8, 16, oh, ow)
    eye_l = _box_mean(ii, *_EYES, *_LEFT_EYE_X, oh, ow)
    eye_r = _box_mean(ii, *_EYES, *_RIGHT_EYE_X, oh, ow)
    bridge = _box_mean(ii, *_EYES, *_BRIDGE_X, oh, ow)
    eyes = 0.5 * (eye_l + eye_r)

    f_eye_cheek = (midface - eyes) / std   # eyes darker than cheeks
    f_eye_brow = (forehead - eyes) / std   # ... and than forehead
    f_bridge = (bridge - eyes) / std       # bright nose bridge
    f_mouth = (midface - mouth) / std      # dark mouth
    f_sym = -(eye_l - eye_r).abs() / std   # left/right eye symmetry

    score = 1.0 * f_eye_cheek + 1.0 * f_eye_brow + 0.6 * f_bridge + 0.6 * f_mouth + 0.5 * f_sym
    return torch.where(std > 4.0, score, torch.full_like(score, -1e9))


def _greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float, keep: int) -> FaceDetections:
    """Greedy IoU suppression over a fixed candidate set: ``keep`` trips,
    each taking the best live candidate (``argmax``'s first index) and
    killing it and everything overlapping it; no host read."""
    n = boxes.shape[0]
    b = boxes
    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    overlap = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9) > iou_threshold

    arange = torch.arange(n, device=boxes.device)
    alive = valid
    neg_inf = torch.full_like(scores, float("-inf"))
    idx, mask = [], []
    for _ in range(keep):
        s = torch.where(alive, scores, neg_inf)
        best = torch.argmax(s, dim=0, keepdim=True)        # (1,)
        ok = s.gather(0, best) > float("-inf")
        idx.append(torch.where(ok, best, torch.zeros_like(best)))
        mask.append(ok)
        alive = alive & ~overlap.index_select(0, best)[0] & (arange != best)
    idx, mask = torch.cat(idx), torch.cat(mask)
    return FaceDetections(boxes=boxes.index_select(0, idx), scores=scores.index_select(0, idx), mask=mask)


def detect_faces(gray: torch.Tensor, threshold: float = 1.1, num_levels: int = 5, scale_step: float = 1.35,
                 max_faces: int = 8, candidates: int = 64, iou_threshold: float = 0.3) -> FaceDetections:
    """Multi-scale dense Haar-contrast detection on a gray (H, W) image:
    up to ``max_faces`` boxes in input pixels. Level k scores windows of
    24 * scale_step^k pixels; the local peaks of every level are merged
    by score and deduplicated by IoU."""
    H, W = gray.shape
    gray = gray.float()
    all_boxes, all_scores, all_valid = [], [], []
    per_level = max(candidates // num_levels, 4)
    for k in range(num_levels):
        scale = scale_step ** k
        lh, lw = max(int(round(H / scale)), _WIN), max(int(round(W / scale)), _WIN)
        img_k = bilinear_resize(gray, (lh, lw)) if (lh, lw) != (H, W) else gray
        peaks = nms_heatmap(_level_scores(img_k)[None], threshold=threshold, max_peaks=per_level)
        uv = peaks.xy[0]  # (P, 2) x, y of the window corner in level pixels
        sx, sy = W / lw, H / lh
        x1, y1 = uv[:, 0] * sx, uv[:, 1] * sy
        all_boxes.append(torch.stack([x1, y1, x1 + _WIN * sx, y1 + _WIN * sy], dim=1))
        all_scores.append(peaks.score[0])
        all_valid.append(peaks.mask[0] & (peaks.score[0] > threshold))
    return _greedy_nms(torch.cat(all_boxes), torch.cat(all_scores), torch.cat(all_valid), iou_threshold, max_faces)


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``padding="SAME"``: each side padded so the output is
    ceil(in / stride), the odd pixel at the end: (0, 1) for a stride-2 3x3
    conv on an even size, (1, 1) on an odd one."""
    pads = []
    for size, k, s in zip(x.shape[:-3:-1], conv.kernel_size[::-1], conv.stride[::-1]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


class FaceDetectorNet(nn.Module):
    """Centre-heatmap face detector: (N, 1, H, W) in [0, 1] -> (heat logits,
    log face size / 4), (N, ceil(H/4), ceil(W/4)) each. flax's ``Conv_0`` to
    ``Conv_3`` are ``convs`` (the first two stride 2), ``Conv_4`` ``heat``,
    ``Conv_5`` ``size``."""

    def __init__(self, features: Sequence[int] = (16, 32, 64)):
        super().__init__()
        widths = [1, *features, 64]
        self.convs = nn.ModuleList(
            nn.Conv2d(widths[i], widths[i + 1], 3, stride=2 if i < 2 else 1) for i in range(len(widths) - 1))
        self.heat = nn.Conv2d(64, 1, 1)
        self.size = nn.Conv2d(64, 1, 1)

    @fp32()
    def forward(self, x):
        for conv in self.convs:
            x = F.relu(_conv_same(conv, x))
        return self.heat(x)[:, 0], self.size(x)[:, 0]


def decode_detector_net(heat: torch.Tensor, size: torch.Tensor, threshold: float = 0.0, max_faces: int = 8,
                        iou_threshold: float = 0.4) -> FaceDetections:
    """Peaks of the (h, w) centre heatmap -> FaceDetections in input pixels:
    2 x ``max_faces`` peaks, each with the box side exp(size) * 4 read at
    its pixel (a gather, no host read), then the greedy box-IoU dedup."""
    peaks = nms_heatmap(heat[None], threshold=threshold, max_peaks=2 * max_faces)
    xy = peaks.xy[0]
    uv = xy * 4.0
    h, w = size.shape
    u = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    v = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
    s = torch.exp(size.reshape(-1).gather(0, v * w + u)) * 4.0
    half = s / 2.0
    boxes = torch.stack([uv[:, 0] - half, uv[:, 1] - half, uv[:, 0] + half, uv[:, 1] + half], dim=1)
    return _greedy_nms(boxes, peaks.score[0], peaks.mask[0], iou_threshold, max_faces)
