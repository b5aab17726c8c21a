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
