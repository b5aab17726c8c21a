"""CUDA-graph capture of a fixed-shape function of tensors.

``captured(fn, inputs, cfg)`` returns ``fn(*inputs, cfg)``. On CUDA
tensors a key's first call runs eagerly and then captures ``fn`` as one
CUDA graph; later calls at the key replay it. Other tensors run eagerly,
and nothing is counted. The contract a caller keeps:

- ``fn`` reads nothing back to the host (a capture records kernels, and
  a host read inside one raises);
- ``fn``'s inputs fix its shapes, and of the config it reads only ``cfg``,
  which is hashable (a frozen dataclass). The key is ``fn``, the device,
  each input's shape and dtype, the whole ``cfg`` and both TF32 flags, so
  a config that differs in any field captures its own graph;
- one thread uses a key at a time: two threads would share its buffers.
"""

from __future__ import annotations

from collections import Counter

import torch

from perception_tpu_torch.utils.profiler import count_launch, tallied

# Graphs captured and replayed, by fn.__name__ (the kernels' ``launches_by_shape`` give the shapes).
captures, replays = Counter(), Counter()


class _Graph:
    """``fn(*inputs, cfg)`` captured once: static inputs that each call's
    tensors are copied into, and static outputs that each replay
    overwrites and that leave only as clones, so no returned tensor
    aliases the next replay's. The replay runs the captured kernels with
    the eager call's launch plans, in its order, so its results equal the
    eager call's bit for bit. The launches that ``count_launch`` saw
    during the capture (``tally``) are counted again at each replay."""

    def __init__(self, fn, inputs, cfg):
        self.inputs = [torch.empty_like(t) for t in inputs]
        self.device = inputs[0].device
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls meanwhile are not the capture's concern.
        with torch.cuda.device(self.device), tallied() as self.tally, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs, cfg)

    def __call__(self, inputs):
        with torch.cuda.device(self.device):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
            self.graph.replay()
            for (wrapper, shape), n in self.tally.items():
                count_launch(wrapper, shape, n)
            return tuple(t.clone() for t in self.outputs)


_GRAPHS = {}  # _key -> _Graph


def _key(fn, inputs, cfg):
    return (fn, inputs[0].device, tuple((tuple(t.shape), t.dtype) for t in inputs), cfg,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def captured(fn, inputs, cfg):
    """``fn(*inputs, cfg)``, through the graph at its key on CUDA tensors."""
    if inputs[0].device.type != "cuda":
        return fn(*inputs, cfg)
    key = _key(fn, inputs, cfg)
    graph = _GRAPHS.get(key)
    if graph is None:
        out = fn(*inputs, cfg)
        _GRAPHS[key] = _Graph(fn, inputs, cfg)
        captures[fn.__name__] += 1
        return out
    out = graph(inputs)
    replays[fn.__name__] += 1
    return out
