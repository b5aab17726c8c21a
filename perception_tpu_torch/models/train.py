"""Training loop for the CNN models (the Caffe Solver capability).

Counterpart of ``perception_tpu/models/train.py`` in PyTorch's idiom:

* ``make_optimizer`` returns an ``Optimizer``: the kind, the learning
  rate (a float or a schedule, a callable of the update count as in
  optax) and the weight decay. Its ``init`` builds the ``torch.optim``
  optimizer over a net's parameters with optax's rule for the kind and
  optax's initial state, made at once as ``optax``'s ``init`` makes it.
  ``sgd``, ``momentum`` (0.9), ``nesterov``, ``adam`` (b1 0.9, b2 0.999,
  eps 1e-8), ``adamw`` and ``adadelta`` (rho 0.9, eps 1e-6) are
  ``torch.optim``'s, which compute optax's rules up to rounding.
  ``rmsprop`` and ``adagrad`` are not: optax's ``rmsprop`` decays by 0.9
  with eps inside the square root and its ``adagrad`` starts its sum at
  0.1 with eps 1e-7 inside the root, so both are written here
  (``RMSprop``, ``Adagrad``). ``adamw``'s weight decay is passed, never
  torch's default of 0.01.
* ``cosine_decay_schedule``: optax's schedule, evaluated at the update
  count before the update (0 for the first), in float32.
* ``TrainState``: the net (an ``nn.Module`` whose parameters need
  gradients; it is the parameters), the ``torch.optim`` optimizer (the
  optimizer state) and the update count.
* ``pose_loss``: the CMU two-branch loss, the mean of the masked PAF
  error plus the mean of the masked heatmap error, on channel-first maps.
* ``make_train_step``: one update in place. It returns the loss as a
  tensor and reads nothing back from the device, so a step never waits
  for the card.
* ``snapshot`` / ``restore``: the state through ``utils/checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

KINDS = ("sgd", "momentum", "nesterov", "adam", "adamw", "rmsprop", "adagrad", "adadelta")


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) *
    (0.5 * (1 + cos(pi * t / T))) ** exponent + alpha)`` with t clipped to
    T = ``decay_steps``, computed in float32 as optax computes it."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        t = f32(min(float(count), float(decay_steps)))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        return float(f32(init_value) * (f32(1.0 - alpha) * cosine ** f32(exponent) + f32(alpha)))

    return schedule


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (its defaults: no centring, no momentum):
    ``nu = (1 - decay) * g**2 + decay * nu`` from 0, then
    ``p -= lr * g * rsqrt(nu + eps)``. ``torch.optim.RMSprop`` decays by
    0.99 and divides by ``sqrt(nu) + eps``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p]["nu"]
                nu.copy_((1.0 - decay) * p.grad.square() + decay * nu)
                p.add_(torch.rsqrt(nu + eps) * p.grad, alpha=-lr)
        return loss


class Adagrad(torch.optim.Optimizer):
    """optax's ``adagrad``: ``s = g**2 + s`` from ``initial_accumulator_value``
    (0.1), then ``p -= lr * where(s > 0, rsqrt(s + eps), 0) * g`` with eps
    1e-7. ``torch.optim.Adagrad`` starts at 0 and divides by
    ``sqrt(s) + 1e-10``."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(p, initial_accumulator_value)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            eps, lr = group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                s = self.state[p]["sum_of_squares"]
                s.copy_(p.grad.square() + s)
                inv = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
                p.add_(inv * p.grad, alpha=-lr)
        return loss


def _zeros(p):
    return torch.zeros_like(p, memory_format=torch.preserve_format)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer rule: what ``optax``'s ``GradientTransformation`` is to
    the JAX package. ``init(params)`` builds its ``torch.optim`` optimizer
    with the initial state that optax's ``init`` makes (zeros, or 0.1 for
    ``adagrad``), so the state's structure is fixed before the first step."""

    kind: str
    learning_rate: Union[float, Callable[[int], float]]
    weight_decay: float = 0.0

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (0 for the first)."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> torch.optim.Optimizer:
        params = list(params)
        lr = self.lr(0)
        kind = self.kind
        if kind in ("sgd", "momentum", "nesterov"):
            momentum = 0.0 if kind == "sgd" else 0.9
            opt = torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=kind == "nesterov")
            state = {} if kind == "sgd" else {"momentum_buffer": _zeros}
        elif kind in ("adam", "adamw"):
            if kind == "adam":
                opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
            else:
                opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay)
            state = {"step": lambda p: torch.tensor(0.0), "exp_avg": _zeros, "exp_avg_sq": _zeros}
        elif kind == "rmsprop":
            return RMSprop(params, lr=lr)
        elif kind == "adagrad":
            return Adagrad(params, lr=lr)
        elif kind == "adadelta":
            opt = torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
            state = {"step": lambda p: torch.tensor(0.0), "square_avg": _zeros, "acc_delta": _zeros}
        else:
            raise ValueError(f"unknown optimizer {kind!r}")
        for p in params:
            opt.state[p].update({name: make(p) for name, make in state.items()})
        return opt


def make_optimizer(learning_rate: Union[float, Callable[[int], float]] = 1e-3, kind: str = "adam",
                   weight_decay: float = 0.0) -> Optimizer:
    """The solver zoo: sgd / momentum / nesterov / adam / adamw / rmsprop /
    adagrad / adadelta, with optax's rules (module docstring)."""
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer {kind!r}")
    return Optimizer(kind, learning_rate, weight_decay)


class TrainState(NamedTuple):
    params: nn.Module                  # the net; updated in place
    opt_state: torch.optim.Optimizer   # its optimizer and the optimizer's state
    step: int                          # updates so far


def init_train_state(net: nn.Module, optimizer: Optimizer) -> TrainState:
    """The net with gradients on (the fixture loaders and ``init_posenet``
    return nets without), its optimizer's initial state, count 0."""
    net.requires_grad_(True).train()
    return TrainState(params=net, opt_state=optimizer.init(net.parameters()), step=0)


def pose_loss(net: nn.Module, batch: dict) -> torch.Tensor:
    """Two-branch MSE: PAF + heatmap regression with an optional validity
    mask (B, h, w) (masked pixels carry no gradient). ``batch["image"]``
    is (B, 3, H, W), ``"paf"`` (B, 2L, h, w), ``"heatmap"`` (B, P+1, h, w):
    channel-first, so the mask broadcasts on axis 1."""
    paf_pred, hm_pred = net(batch["image"])
    m = batch.get("mask")
    paf_err = (paf_pred - batch["paf"]) ** 2
    hm_err = (hm_pred - batch["heatmap"]) ** 2
    if m is not None:
        paf_err = paf_err * m[:, None]
        hm_err = hm_err * m[:, None]
    return paf_err.mean() + hm_err.mean()


def make_train_step(optimizer: Optimizer, loss_fn: Callable = pose_loss, axis_name: Optional[str] = None):
    """One update: ``step(state, batch) -> (state, loss)``. ``loss_fn(net,
    batch)`` gives a scalar tensor; the learning rate is
    ``optimizer.lr(state.step)``. The net and its optimizer are updated in
    place; the returned state carries them with the count plus one.

    ``axis_name`` (the JAX package's ``pmean`` of gradients over a mesh)
    belongs to the multi-process port and raises here."""
    if axis_name is not None:
        raise NotImplementedError("make_train_step: data-parallel training (axis_name) is not ported yet")

    def step(state: TrainState, batch: dict):
        net, opt = state.params, state.opt_state
        lr = optimizer.lr(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net, batch)
        loss.backward()
        opt.step()
        return TrainState(net, opt, state.step + 1), loss.detach()

    return step


def _state_tree(state: TrainState) -> dict:
    return {"params": state.params.state_dict(), "opt_state": state.opt_state.state_dict(),
            "step": torch.tensor(state.step, dtype=torch.int64)}


def snapshot(path, state: TrainState) -> None:
    """The net's and the optimizer's state and the count, as
    ``utils.checkpoint.save_torch`` writes them."""
    from perception_tpu_torch.utils.checkpoint import save_torch

    save_torch(path, _state_tree(state))


def restore(path, like: TrainState) -> TrainState:
    """A state saved by ``snapshot``, loaded into ``like``'s net and
    optimizer (their values are replaced; ``like`` supplies the structure)."""
    from perception_tpu_torch.utils.checkpoint import load_torch

    tree = load_torch(path, _state_tree(like))
    like.params.load_state_dict(tree["params"])
    like.opt_state.load_state_dict(tree["opt_state"])
    return TrainState(like.params, like.opt_state, int(tree["step"]))
