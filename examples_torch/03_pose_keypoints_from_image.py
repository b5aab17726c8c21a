"""Example 03 — human-pose keypoints from an image.

The OpenPose flow (poseExtractorCaffe.cpp:202-340): two-branch CNN ->
heatmap NMS with subpixel refinement -> PAF line-integral pair scoring
-> greedy skeleton assembly, at a tiny net resolution (the reference CI
smoke-runs with --net_resolution -1x32 the same way). The random weights
and image are the JAX example's (``jax.random.key(0)`` and ``key(1)``,
drawn by ``utils/jax_random``).

Part 2 runs the *trained* tiny PoseNet fixture (weights trained in-repo
on synthetic skeleton scenes, tests/fixtures/posenet_mpi15_tiny.msgpack)
and recovers actual multi-person skeletons from rendered images: the JAX
example's ``evaluate_pck(key(7))`` scenes.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.models.pose import (  # noqa: E402
    TOPOLOGIES,
    extract_people,
    init_posenet,
)
from perception_tpu_torch.utils import jax_random  # noqa: E402
from perception_tpu_torch.utils.keypoints import keep_top_n_people  # noqa: E402


def main(dev=None) -> dict:
    dev = device(dev)
    topology = "COCO_18"
    net_hw = (64, 64)
    parts, pairs = TOPOLOGIES[topology]
    print(f"topology {topology}: {len(parts)} parts, {len(pairs)} limb pairs")

    params = init_posenet(jax_random.key(0), topology, device=dev)
    image = torch.as_tensor(jax_random.uniform(jax_random.key(1), (96, 96, 3)), device=dev)

    with torch.no_grad():
        people = extract_people(params, image, topology, scales=(1.0,), net_hw=net_hw)
    kp = host(people.keypoints)
    n = int(people.mask.sum())
    print(f"people detected (random weights, so ~noise): {n}; "
          f"keypoint tensor {kp.shape}")

    top_kp, top_scores, top_mask = keep_top_n_people(
        people.keypoints, people.score, people.mask, n=2
    )
    kept = int(top_mask.sum())
    print(f"keep_top_n_people(2) -> {kept} kept "
          f"of capacity {top_kp.shape[0]}")
    out = {"people_random": n, "kept": kept, "keypoints_shape": kp.shape}

    # --- part 2: trained fixture -> real skeletons from a real image ---
    from perception_tpu_torch.models.pose_fixture import evaluate_pck, fixture_available, load_fixture

    if not fixture_available():
        print("trained fixture absent (run tools_torch/train_pose_fixture.py); "
              "skipping part 2")
        return out
    trained = load_fixture(dev)
    with torch.no_grad():
        pck, recall = evaluate_pck(trained, jax_random.key(7), n_scenes=2, device=dev)
    print(f"trained tiny PoseNet on fresh synthetic scenes: "
          f"PCK={pck:.2f}, person recall={recall:.2f}")
    assert recall > 0.5, "trained net failed to find people"
    return {**out, "pck": pck, "recall": recall}


def main_facade(dev=None) -> dict:
    """The same pipeline through the Perception facade (wrapper.py), the
    reference Wrapper::emplaceAndPop flow in a few lines."""
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructInput,
        WrapperStructPose,
    )

    dev = device(dev)
    frames = [np.random.RandomState(i).rand(96, 96, 3).astype(np.float32)
              for i in range(2)]
    engine = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64), top_n=2),
        input=WrapperStructInput(source=frames),
        device=dev,
    )
    counts = []
    for datum in engine.exec():
        n = int(np.asarray(host(datum.people.mask)).sum())
        counts.append(n)
        print(f"facade frame {datum.frame_index}: {n} people")
    return {"facade_people": counts}


if __name__ == "__main__":
    main()
    main_facade()
