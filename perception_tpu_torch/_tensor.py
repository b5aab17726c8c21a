"""Small tensor helpers shared by the port's modules."""

from __future__ import annotations

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
