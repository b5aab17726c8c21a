"""Multi-person 2-D pose estimation: CNN + heatmap/PAF decode.

Counterpart of ``perception_tpu/models/pose.py``:

* the four core topologies (BODY_25, COCO_18, MPI_15, CAR_12) and
  ``lookup_topology``, which also reaches the full zoo of
  ``models/topologies.py``;
* ``PoseNet``: the two-branch multi-stage CNN as ``torch.nn`` modules,
  channel-first (NCHW) where flax is NHWC. Its convolutions are
  ``torch.nn.functional.conv2d`` (cuDNN on the card), as the JAX package's
  are XLA's ``lax.conv`` outside any Pallas kernel. Weights come from a
  flax tree through ``convert.posenet_from_flax`` or from
  ``init_posenet``;
* ``decode_people`` and ``extract_people``: image -> resize -> CNN ->
  merge -> heatmap NMS -> PAF scoring -> greedy matching -> people, for one
  frame or a batch, with fixed capacities and no host read.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perception_tpu_torch._tensor import const
from perception_tpu_torch.ops.heatmap import nms_heatmap
from perception_tpu_torch.ops.paf import People, assemble_people, greedy_match, paf_pair_scores
from perception_tpu_torch.ops.resize import resize

# --- topology zoo ----------------------------------------------------------

BODY_25_PARTS = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
]

BODY_25_PAIRS = np.array(
    [
        (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
        (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
        (15, 17), (0, 16), (16, 18), (14, 19), (19, 20), (14, 21), (11, 22),
        (22, 23), (11, 24),
    ],
    np.int32,
)

COCO_18_PARTS = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "REye",
    "LEye", "REar", "LEar",
]

COCO_18_PAIRS = np.array(
    [
        (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
        (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
        (0, 15), (15, 17),
    ],
    np.int32,
)

MPI_15_PARTS = [
    "Head", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle", "Chest",
]

MPI_15_PAIRS = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 14),
        (14, 8), (8, 9), (9, 10), (14, 11), (11, 12), (12, 13),
    ],
    np.int32,
)

# Vehicle keypoints (CAR_12): 4 wheels, 4 lights, 4 roof corners.
CAR_12_PARTS = [
    "FRWheel", "FLWheel", "BRWheel", "BLWheel", "FRLight", "FLLight",
    "BRLight", "BLLight", "FRTop", "FLTop", "BRTop", "BLTop",
]

CAR_12_PAIRS = np.array(
    [
        (4, 5), (4, 6), (5, 7), (6, 7), (4, 0), (0, 2), (6, 2), (5, 1),
        (1, 3), (7, 3), (8, 9), (8, 10), (9, 11), (10, 11), (4, 8), (5, 9),
        (6, 10), (7, 11),
    ],
    np.int32,
)

TOPOLOGIES = {
    "BODY_25": (BODY_25_PARTS, BODY_25_PAIRS),
    "COCO_18": (COCO_18_PARTS, COCO_18_PAIRS),
    "MPI_15": (MPI_15_PARTS, MPI_15_PAIRS),
    "CAR_12": (CAR_12_PARTS, CAR_12_PAIRS),
}


def lookup_topology(name: str):
    """(part names, (L, 2) pairs) of a topology: the four core ones here,
    the full zoo in models/topologies."""
    if name in TOPOLOGIES:
        return TOPOLOGIES[name]
    from perception_tpu_torch.models.topologies import FULL_ZOO

    return FULL_ZOO[name]


# --- network ---------------------------------------------------------------

def _conv3(cin: int, cout: int) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (3, 3), padding="SAME")``: symmetric padding 1."""
    return nn.Conv2d(cin, cout, 3, padding=1)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, layers: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            _conv3(in_channels if i == 0 else features, features) for i in range(layers))

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


class Stage(nn.Module):
    """One refinement stage: ``depth`` 3x3 convs, a 1x1 mix, two 1x1 heads."""

    def __init__(self, in_channels: int, paf_channels: int, hm_channels: int,
                 width: int = 96, depth: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(_conv3(in_channels if i == 0 else width, width) for i in range(depth))
        self.mix = nn.Conv2d(width, width, 1)
        self.paf = nn.Conv2d(width, paf_channels, 1)
        self.hm = nn.Conv2d(width, hm_channels, 1)

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.mix(x))
        return self.paf(x), self.hm(x)


class PoseNet(nn.Module):
    """Two-branch multi-stage pose CNN (CMU architecture shape).

    Input (N, 3, H, W) float in [0, 1]; outputs at stride 8:
    (pafs (N, 2L, H/8, W/8), heatmaps (N, P+1, H/8, W/8)). Later stages
    take ``cat([features, paf, hm])`` on the channel axis, the flax order.

    The JAX package runs in full float32. cuDNN's convolutions default to
    TF32 on the card (``torch.backends.cudnn.allow_tf32``), which keeps
    about three decimal digits; callers switch it off
    (``torch.backends.cudnn.allow_tf32 = False``) for float32 results, as
    ``chip_smoke.py`` and the card tests do.
    """

    def __init__(self, num_parts: int = 25, num_limbs: int = 24, num_stages: int = 3,
                 backbone_widths: Sequence[int] = (32, 64, 128), stage_width: int = 96,
                 stage_depth: int = 4, in_channels: int = 3):
        super().__init__()
        self.num_parts, self.num_limbs = num_parts, num_limbs
        self.stage_depth = stage_depth
        widths = [in_channels, *backbone_widths]
        self.backbone = nn.ModuleList(ConvBlock(widths[i], widths[i + 1]) for i in range(len(backbone_widths)))
        self.features = ConvBlock(widths[-1], widths[-1])
        paf_c, hm_c = 2 * num_limbs, num_parts + 1  # + background
        self.stages = nn.ModuleList(
            Stage(widths[-1] + (paf_c + hm_c if s else 0), paf_c, hm_c, stage_width, stage_depth)
            for s in range(num_stages))

    def forward(self, x):
        for block in self.backbone:  # 3 pools -> stride 8
            x = F.max_pool2d(block(x), 2)
        feats = self.features(x)
        paf, hm = self.stages[0](feats)
        for stage in self.stages[1:]:
            paf, hm = stage(torch.cat([feats, paf, hm], dim=1))
        return paf, hm


# --- extraction ------------------------------------------------------------

def decode_people(
    pafs: torch.Tensor,        # (..., 2L, h, w) channel-first merged fields
    heatmaps: torch.Tensor,    # (..., P, H, W) merged part heatmaps (no background)
    limb_pairs,                # (L, 2) numpy or tensor
    num_parts: int,
    max_peaks: int = 32,
    max_people: int = 16,
    peak_threshold: float = 0.1,
    min_person_parts: int = 3,
    paf_stride: float = 1.0,
) -> People:
    """Heatmaps + PAFs -> assembled skeletons (the post-CNN pipeline).

    ``paf_stride``: the PAF grid's stride relative to the peak coordinate
    frame; a peak at x samples the field at (x + 0.5) / stride - 0.5 (the
    half-pixel-centre alignment of ``jax.image.resize``).
    """
    dev = heatmaps.device
    pairs = limb_pairs.to(dev, torch.int64) if isinstance(limb_pairs, torch.Tensor) \
        else torch.from_numpy(np.asarray(limb_pairs, np.int64)).to(dev, non_blocking=True)
    peaks = nms_heatmap(heatmaps, threshold=peak_threshold, max_peaks=max_peaks)
    stride = const(float(paf_stride), heatmaps)

    def to_paf(xy):
        return (xy + 0.5) / stride - 0.5

    a, b = pairs[:, 0], pairs[:, 1]
    scores = paf_pair_scores(
        pafs[..., 0::2, :, :], pafs[..., 1::2, :, :],
        to_paf(peaks.xy.index_select(-3, a)), peaks.mask.index_select(-2, a),
        to_paf(peaks.xy.index_select(-3, b)), peaks.mask.index_select(-2, b),
    )  # (..., L, K, K)
    matches = greedy_match(scores)  # (..., L, E)
    return assemble_people(
        pairs, matches.a_idx, matches.b_idx, matches.score, matches.mask,
        peaks.xy, peaks.score, peaks.mask,
        num_parts=num_parts, max_peaks=max_peaks, max_people=max_people,
        min_person_parts=min_person_parts,
    )


def _merge(channel_first_maps, out_hw):
    """Resize each scale's (..., C, h, w) maps to ``out_hw`` and average."""
    return torch.stack([resize(m, out_hw) for m in channel_first_maps]).mean(dim=0)


@torch.no_grad()
def extract_people(
    net: PoseNet,
    image: torch.Tensor,
    topology: str = "BODY_25",
    scales: Sequence[float] = (1.0,),
    net_hw: Tuple[int, int] = (368, 368),
    **decode_kwargs,
) -> People:
    """Full forward pass: image (H, W, 3) or (B, H, W, 3) in [0, 1] -> People
    (with a leading B for a batch).

    Multi-scale: the image is resized to ``scale * net_hw`` per scale, run
    through the net, and the maps are merged: heatmaps at net resolution
    (NMS wants fine peaks), PAFs on the common stride-8 grid, where they
    are sampled (``decode_people``'s ``paf_stride=8``). ``net``'s head
    sizes must match the topology.
    """
    parts, pairs = lookup_topology(topology)
    P = len(parts)
    x = image.movedim(-1, -3)  # (..., 3, H, W)
    lead = x.shape[:-3]
    paf_scales, hm_scales = [], []
    for s in scales:
        h = int(net_hw[0] * s) // 8 * 8
        w = int(net_hw[1] * s) // 8 * 8
        img_s = resize(x, (h, w)).reshape(-1, 3, h, w).contiguous()
        paf, hm = net(img_s)
        paf_scales.append(paf.reshape(lead + paf.shape[1:]))
        hm_scales.append(hm[:, :P].reshape(lead + (P,) + hm.shape[2:]))  # drop background

    out_hw = (net_hw[0] // 8 * 8, net_hw[1] // 8 * 8)
    s8_hw = (out_hw[0] // 8, out_hw[1] // 8)
    pafs = _merge(paf_scales, s8_hw)
    hms = _merge(hm_scales, out_hw)
    return decode_people(pafs, hms, pairs, num_parts=P, paf_stride=8.0, **decode_kwargs)


def init_posenet(generator: torch.Generator, topology: str = "BODY_25", device="cuda") -> PoseNet:
    """A ``PoseNet`` for ``topology`` with flax's default initialisation,
    drawn from ``generator`` (a CPU generator): kernels LeCun-normal
    (truncated to 2 standard deviations, scaled to unit variance over the
    fan-in), biases 0."""
    parts, pairs = lookup_topology(topology)
    net = PoseNet(num_parts=len(parts), num_limbs=len(pairs))
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, nn.Conv2d):
                w = module.weight
                std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                module.bias.zero_()
    return net.requires_grad_(False).eval().to(device)
