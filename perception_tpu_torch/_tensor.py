"""Small tensor helpers shared by the port's modules."""

from __future__ import annotations

import contextlib

import torch


def const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant of ``like``'s dtype on ``like``'s device.

    ``torch.tensor(values, device="cuda")`` synchronises the host with
    the card after its copy; this copies without that synchronisation.
    As an operand it also keeps a division a true float32 division on
    CUDA, where dividing by a Python float is a reciprocal multiply.
    """
    return torch.tensor(values, dtype=like.dtype).to(like.device, non_blocking=True)


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor ``i``, as a gather on the device:
    indexing with a 0-dim CUDA tensor reads it to the host first."""
    return x.index_select(0, i.reshape(1))[0]


def consts(like: torch.Tensor, *values):
    """Each Python number as a ``const`` like ``like``; tensors pass through
    (intrinsics given either way)."""
    return tuple(v if isinstance(v, torch.Tensor) else const(float(v), like) for v in values)


@contextlib.contextmanager
def fp32():
    """Full float32 inside the block: TF32 off for cuDNN's convolutions
    and cuBLAS's matmuls, the caller's two settings restored on exit.
    cuDNN defaults to TF32 on the card, which keeps about three decimal
    digits; the JAX package computes in float32. Also a decorator
    (``@fp32()``). ``torch.backends.cudnn.flags`` is not used: it also
    resets ``benchmark`` and ``deterministic``."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
