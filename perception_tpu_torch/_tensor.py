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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA's and numpy's.

    torch's CPU ``sqrt`` is not correctly rounded in every build on every
    host: torch 2.13.0+cpu on an AMD EPYC puts 2,876,932 of the 2^24
    float32 roots in [1, 4) one ulp off, whatever
    ``ATEN_CPU_CAPABILITY``. Its float64 root rounded to float32 equals
    the correctly rounded one on all 2^24 (and scaling by 4 is exact), so
    a float32 root on the CPU is taken that way. CUDA's ``sqrt`` is
    correctly rounded and stays one kernel."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def norm_rn(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis: the squares' sum (on the CPU a
    3- or 4-wide row adds left to right), then :func:`sqrt_rn`
    (``torch.linalg.vector_norm`` takes torch's root)."""
    return sqrt_rn(torch.sum(x * x, dim=-1, keepdim=keepdim))


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
