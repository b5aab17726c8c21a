"""Build a CUDA source of ``perception_tpu_torch/csrc`` at first use and
load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/perception_tpu_torch/`` at the root
of the checkout, under a name keyed on a hash of the source and the
flags, so an edited source or changed flags give a fresh build. Nothing
is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "perception_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def find_nvcc() -> str:
    """``nvcc`` on PATH, else the CUDA toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access(_NVCC_FALLBACK, os.X_OK):
        nvcc = _NVCC_FALLBACK
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found on PATH or at {_NVCC_FALLBACK}: the CUDA kernels of "
            "perception_tpu_torch are compiled from csrc/ at first use"
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built for the current source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.

    ptxas's report (registers, shared memory, spills) is kept beside the
    library as ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; loaded once per process."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA card ``device_index``, for the kernels' launch plans."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
