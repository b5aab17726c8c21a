"""Shared scaffolding of the PyTorch examples.

The examples run on the CUDA card by default and stop, naming the switch,
where torch sees none: ``PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE=cpu`` asks
for the CPU (the test suite smoke-runs them that way). This is the reverse
of the JAX examples' default (``examples/_common.setup_backend`` picks the
CPU unless told otherwise): the port's entry points run on the card unless
the caller asks for the CPU. Each example's ``main(device=None)`` takes the
device from its argument, else from the switch, and returns its headline
numbers as a dict.
"""

from __future__ import annotations

import importlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

DEVICE_ENV = "PERCEPTION_TPU_TORCH_EXAMPLES_DEVICE"
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def device(requested=None) -> torch.device:
    """The example's device: ``requested``, else the switch, else the card.
    Raises where the card is asked for and torch sees none."""
    dev = torch.device(requested or os.environ.get(DEVICE_ENV) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"this example runs on a CUDA card and torch sees none; set {DEVICE_ENV}=cpu to run it on the CPU"
        )
    return dev


def load(stem: str):
    """An example as a module (``examples_torch.<stem>``), e.g.
    ``load("01_cuboid_pose_from_depth").main()``; a spawned rank imports
    its example this way too."""
    return importlib.import_module(f"examples_torch.{stem}")


def generator(dev: torch.device, seed: int = 0) -> torch.Generator:
    """A generator on ``dev`` for the draws inside an algorithm (RANSAC
    triplets), where the JAX example passes ``jax.random.key(seed)``."""
    return torch.Generator(device=dev).manual_seed(seed)


def small_camera(width: int = 160, height: int = 120):
    """D435 depth intrinsics scaled down to ``width`` (4x by default)."""
    from perception_tpu_torch.geometry.camera import PinholeCamera

    d435 = PinholeCamera.d435_depth()
    s = width / d435.width
    return PinholeCamera.from_K(
        [float(d435.fx) * s, 0.0, float(d435.cx) * s,
         0.0, float(d435.fy) * s, float(d435.cy) * s,
         0.0, 0.0, 1.0],
        width=width, height=height,
    )


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def print_pose(name: str, T) -> None:
    T = host(T)
    t = T[:3, 3]
    print(f"{name}: t = [{t[0]:+.4f} {t[1]:+.4f} {t[2]:+.4f}] m")
    for row in T[:3, :3]:
        print(f"    R | {row[0]:+.3f} {row[1]:+.3f} {row[2]:+.3f}")
