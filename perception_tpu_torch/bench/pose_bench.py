"""Pose extraction at the reference's own scale: BODY_25 at 368x368.

Counterpart of ``benchmarks/pose_bench.py``'s ``run``. The reference
publishes two stage numbers (BASELINE.md): resize+merge ~5 ms on its GPU
and ~20 ms on its CPU (poseExtractorCaffe.cpp:294), NMS ~2 ms and ~7 ms
(:308), both at net resolution 368x368 with BODY_25. This benchmark runs
the port's pipeline at that shape with randomly initialised weights (the
stages' cost does not depend on them) and times the two stages alone, then
the whole image -> People extraction for one frame and for a batch. The
weights and inputs are the JAX benchmark's: ``init_posenet`` from
``jax.random.key(0)``, the image, the batch, the stride-8 maps and the
heatmaps uniform from keys 1-4, drawn through ``utils/jax_random``. Each
time is the mean of ``reps`` calls after one (host clock, ending in a
synchronize on the card). The convolutions are cuDNN's, in float32.

Run: ``python -m perception_tpu_torch.bench.pose_bench [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from perception_tpu_torch.bench.timing import device_of, sync

NET_HW = (368, 368)  # the reference's net resolution
TOPOLOGY = "BODY_25"
BATCH = 8
REPS = 30
REFERENCE_GPU_MS = {"resize_merge": 5.0, "nms": 2.0, "note": "1080 Ti CUDA, poseExtractorCaffe.cpp:294,308"}


def inputs(net_hw=NET_HW, topology: str = TOPOLOGY, batch: int = BATCH, device="cpu"):
    """The JAX benchmark's weights and inputs on ``device``: (net, image
    (H, W, 3), batch (B, H, W, 3), maps (P+1, H/8, W/8), heatmaps (P, H, W))."""
    from perception_tpu_torch.models.pose import init_posenet, lookup_topology
    from perception_tpu_torch.utils import jax_random

    P = len(lookup_topology(topology)[0])
    hw = tuple(net_hw)

    def uniform(seed, shape):
        return torch.from_numpy(jax_random.uniform(jax_random.key(seed), shape)).to(device)

    net = init_posenet(jax_random.key(0), topology, device=device)
    return (net, uniform(1, hw + (3,)), uniform(2, (batch,) + hw + (3,)),
            uniform(3, (P + 1, hw[0] // 8, hw[1] // 8)), uniform(4, (P,) + hw))


def run(net_hw=NET_HW, topology: str = TOPOLOGY, batch: int = BATCH, reps: int = REPS, device="cuda") -> dict:
    from perception_tpu_torch.models.pose import extract_people
    from perception_tpu_torch.ops.heatmap import nms_heatmap, resize_and_merge

    device = device_of(device)
    net, img, imgs, maps, hms = inputs(net_hw, topology, batch, device)

    def timed(f, *a, probe=None, n=reps):
        out = f(*a)
        sync(probe(out) if probe else out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = f(*a)
        sync(probe(out) if probe else out)
        return 1000.0 * (time.perf_counter() - t0) / n

    # Stage 1: resize+merge at the reference's published shape, the
    # stride-8 maps ((P+1) at 46x46) up to net resolution.
    resize_merge_ms = timed(lambda m: resize_and_merge(m[None], tuple(net_hw)), maps)
    # Stage 2: NMS at net resolution over the P part channels.
    nms_ms = timed(lambda h: nms_heatmap(h, threshold=0.1, max_peaks=32), hms, probe=lambda o: o.xy)
    # The whole extraction, image -> People, one frame and a batch.
    single_ms = timed(lambda x: extract_people(net, x, topology, net_hw=tuple(net_hw)), img,
                      probe=lambda o: o.keypoints)
    batch_ms = timed(lambda x: extract_people(net, x, topology, net_hw=tuple(net_hw)), imgs,
                     probe=lambda o: o.keypoints)

    return {
        "topology": topology,
        "net_hw": list(net_hw),
        "resize_merge_ms": round(resize_merge_ms, 3),
        "nms_ms": round(nms_ms, 3),
        "extract_ms_batch1": round(single_ms, 3),
        "extract_fps_batch1": round(1000.0 / single_ms, 1),
        "batch": batch,
        "extract_ms_per_frame_batch": round(batch_ms / batch, 3),
        "extract_fps_batch": round(1000.0 * batch / batch_ms, 1),
        "reference_gpu_ms": dict(REFERENCE_GPU_MS),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    print(json.dumps(run(device="cpu" if args.cpu else "cuda")))


if __name__ == "__main__":
    main()
