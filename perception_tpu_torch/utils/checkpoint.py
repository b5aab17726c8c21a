"""Checkpoint and restore of engine state (SLAM keyframes, pose graph,
odometry, training state).

Counterpart of ``perception_tpu/utils/checkpoint.py``. The reference
checkpoints only Caffe's training state (``Solver::Snapshot``,
``caffe/src/caffe/solver.cpp:420-480``; SIGINT to snapshot,
``util/signal_handler.cpp:71-103``); the engine checkpoints its
perception state too, so that a crashed host can resume a mapping
session. A state is a tree of NamedTuples, dicts, lists and tuples over
tensors, arrays and Python scalars (``None`` is an empty subtree), walked
in ``jax.tree_util``'s order: NamedTuple fields in order, dict entries by
sorted key.

* ``save_npz`` / ``load_npz`` keep the JAX package's file layout:
  ``leaf_{i}`` in that order plus ``__treedef__`` (a description nobody
  reads; ``like`` supplies the structure). Files pass between the two
  packages: the port's ``VoxelHash`` has no ``tableT`` (the TPU's
  transposed table copy), so the port writes ``table.T`` in its place and
  skips it when reading, and ``KeyframeStore.desc`` (int32 words in the
  port, uint32 in JAX) is written as uint32 and read back by viewing the
  bits. So a ``SlamState`` or ``OdometryState`` saved by either package
  loads into the other.
* ``save_orbax`` / ``load_orbax`` behave as the JAX functions do where
  orbax is absent: an npz at ``str(path) + ".npz"`` through ``save_npz`` /
  ``load_npz``, so such a file passes between the packages. orbax needs
  JAX, so the port cannot import it: an orbax checkpoint directory written
  by the JAX package is not readable here.
* ``save_torch`` / ``load_torch``: a ``torch.save`` file of the leaves;
  zero-size leaves round-trip.
* ``install_snapshot_handler``: SIGINT/SIGTERM -> snapshot, then the
  signal's default action.
"""

from __future__ import annotations

import signal
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

# Leaves the JAX package's NamedTuples hold that the port's do not:
# class name -> (field after which it comes, its name, how to make it).
_JAX_EXTRA_LEAVES = {"VoxelHash": ("table", "tableT", lambda t: t.transpose(-1, -2).contiguous())}
# Fields whose JAX dtype differs from the port's only in signedness.
_JAX_DTYPES = {("KeyframeStore", "desc"): np.uint32}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a node, in jax.tree_util's order."""
    if _is_namedtuple(tree):
        return [(name, getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(x) -> bool:
    return isinstance(x, (tuple, list, dict))


def _leaves(tree, jax_layout: bool = False) -> List[Tuple[Any, Any]]:
    """(slot, leaf) pairs in flatten order. ``slot`` is ``(class, field)``
    for a NamedTuple field, else None; with ``jax_layout`` the JAX
    package's extra leaves are included, with slot ``("extra", name)``."""
    out = []

    def walk(node, slot):
        if node is None:
            return
        if not _is_node(node):
            out.append((slot, node))
            return
        cls = type(node).__name__ if _is_namedtuple(node) else None
        extra = _JAX_EXTRA_LEAVES.get(cls) if jax_layout else None
        for key, child in _children(node):
            walk(child, (cls, key) if cls else None)
            if extra is not None and key == extra[0]:
                out.append((("extra", extra[1]), extra[2](child)))

    walk(tree, None)
    return out


def _unflatten(like, leaves):
    """``like``'s structure over ``leaves`` (an iterator, flatten order)."""
    if like is None:
        return None
    if not _is_node(like):
        return next(leaves)
    if _is_namedtuple(like):
        return type(like)(**{k: _unflatten(v, leaves) for k, v in _children(like)})
    if isinstance(like, dict):
        filled = {k: _unflatten(v, leaves) for k, v in _children(like)}
        return {k: filled[k] for k in like}
    return type(like)(_unflatten(v, leaves) for _, v in _children(like))


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if not _is_node(tree):
        return "*"
    name = type(tree).__name__
    return f"{name}[{', '.join(_describe(c) for _, c in _children(tree))}]"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like_leaf(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s kind: a tensor on ``ref``'s device (integer bits
    viewed where only the signedness differs), an array, or a scalar."""
    if isinstance(ref, torch.Tensor):
        want = torch.empty((), dtype=ref.dtype).numpy().dtype
        if arr.dtype != want and arr.dtype.kind in "iu" and want.kind in "iu" and arr.dtype.itemsize == want.itemsize:
            arr = arr.view(want)
        return torch.from_numpy(np.array(arr)).to(ref.device)
    if isinstance(ref, np.ndarray):
        return np.array(arr)
    return type(ref)(arr.item()) if isinstance(ref, (bool, int, float)) else arr


def _npz_path(path) -> str:
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def save_npz(path, state: Any) -> None:
    """Write a state to ``<path>.npz`` in the JAX package's layout."""
    arrays = {}
    for i, (slot, leaf) in enumerate(_leaves(state, jax_layout=True)):
        arr = _to_numpy(leaf)
        if slot in _JAX_DTYPES:
            arr = arr.view(_JAX_DTYPES[slot])
        arrays[f"leaf_{i}"] = arr
    arrays["__treedef__"] = np.frombuffer(_describe(state).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_npz(path, like: Any) -> Any:
    """Restore a state saved by ``save_npz`` of either package; ``like``
    supplies the structure, dtypes and devices (its values are ignored)."""
    with np.load(_npz_path(path)) as data:
        out = [_like_leaf(data[f"leaf_{i}"], ref)
               for i, (slot, ref) in enumerate(_leaves(like, jax_layout=True)) if slot is None or slot[0] != "extra"]
    return _unflatten(like, iter(out))


def save_orbax(path, state: Any) -> None:
    """The JAX ``save_orbax`` without orbax: ``save_npz`` to ``<path>.npz``."""
    save_npz(str(path) + ".npz", state)


def load_orbax(path, like: Any) -> Any:
    """The JAX ``load_orbax`` without orbax: ``load_npz`` of ``<path>.npz``."""
    return load_npz(str(path) + ".npz", like)


def save_torch(path, state: Any) -> None:
    """The state's leaves, in flatten order, as one ``torch.save`` file at
    ``path``."""
    torch.save([leaf for _, leaf in _leaves(state)], str(path))


def load_torch(path, like: Any) -> Any:
    """A file of ``save_torch`` in ``like``'s structure, each tensor on
    ``like``'s device for it."""
    saved = torch.load(str(path), map_location="cpu", weights_only=True)
    refs = [leaf for _, leaf in _leaves(like)]
    if len(saved) != len(refs):
        raise ValueError(f"{path}: {len(saved)} leaves, the structure has {len(refs)}")
    out = [got.to(ref.device) if isinstance(ref, torch.Tensor) else got for got, ref in zip(saved, refs)]
    return _unflatten(like, iter(out))


def install_snapshot_handler(
    save_fn: Callable[[], None],
    signals=(signal.SIGINT, signal.SIGTERM),
) -> None:
    """Caffe-style graceful shutdown: on SIGINT/SIGTERM, snapshot, then
    re-raise the signal with its default action (signal_handler.cpp:71-103)."""
    def handler(signum, frame):
        save_fn()
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)

    for s in signals:
        signal.signal(s, handler)
