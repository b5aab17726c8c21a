"""The (dp, sp) rank mesh and the collectives the distributed steps use.

Counterpart of ``perception_tpu/parallel/mesh.py``. Where the JAX package
lays a mesh over devices and shards one global array across them, the
port lays a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of a process group (``parallel/multihost.initialize``), one rank for
each JAX device, and each rank holds its own block:

- ``dp``: frame / keyframe parallelism (the JAX ``P("dp")``);
- ``sp``: point blocks inside a frame, whose normal equations are summed
  over ``sp``.

Ranks are laid out row-major: rank = d * sp + s. ``frame_sharding`` and
``replicated`` say which block of a global array a rank holds (its
``shard`` cuts that block out of a global numpy array or tensor).

The collectives (``all_reduce``, ``pmean``) take one flat buffer a call,
so a step makes one collective for a whole iteration's sums, as JAX's
``psum`` sums the ``vmap``ped frames in one. A group of ``None`` is a
world of one rank: the collective returns its input, which is how a step
built on ``mesh=None`` runs as the single-rank reference. The backend is
the caller's choice (``multihost.initialize``): NCCL takes CUDA tensors;
gloo takes CPU tensors, and CUDA tensors too for every collective used
here (it stages them through host memory itself).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from perception_tpu_torch._tensor import const

Axis = Union[None, str, Tuple[str, ...]]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def _device_type() -> str:
    """The mesh's device type: "cuda" for NCCL, else "cpu" (gloo's meshes;
    its groups take the tensors of either device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(dp: Optional[int] = None, sp: int = 1) -> DeviceMesh:
    """The (dp, sp) mesh over every rank of the default process group.

    With only ``sp`` given, the other ranks go to ``dp``. ``dp * sp``
    must equal the world size. (The JAX function takes ``devices``; here
    the ranks are the world's.)"""
    n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} ranks")
    return init_device_mesh(_device_type(), (dp, sp), mesh_dim_names=("dp", "sp"))


def flat_mesh(axis: str) -> DeviceMesh:
    """A 1-D mesh over every rank under the dim name ``axis`` (the JAX
    package's ``Mesh(devices.reshape(-1), (axis,))``)."""
    return init_device_mesh(_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis,))


def group(mesh: Optional[DeviceMesh], axis: Axis):
    """The process group over ``axis`` of ``mesh``: one dim name, or a
    tuple of names for all of them at once (the whole mesh, whose group
    is the world's). ``None`` for ``mesh=None``."""
    if mesh is None:
        return None
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if set(names) != set(mesh.mesh_dim_names):
        raise ValueError(f"axes {names}: a group over several dims must span all of {mesh.mesh_dim_names}")
    return dist.group.WORLD


def axis_index(mesh: Optional[DeviceMesh], axis: Axis) -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis size); several dims
    count row-major in the order given. (0, 1) for ``mesh=None``."""
    if mesh is None:
        return 0, 1
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    coord = mesh.get_coordinate()
    index, size = 0, 1
    for name in names:
        i = mesh.mesh_dim_names.index(name)
        index, size = index * mesh.shape[i] + coord[i], size * mesh.shape[i]
    return index, size


class Sharding(NamedTuple):
    """Which block of a global array a rank holds: ``spec`` names, for each
    leading axis, the mesh dim(s) it is split over (None: not split);
    further axes are whole (the JAX ``PartitionSpec``)."""
    mesh: Optional[DeviceMesh]
    spec: Tuple[Axis, ...]

    def block(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's slices of an array of ``shape``."""
        out = []
        for n, axis in zip(shape, self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            i, parts = axis_index(self.mesh, axis)
            if n % parts:
                raise ValueError(f"axis of {n} does not split over {parts} ranks ({axis})")
            out.append(slice(i * (n // parts), (i + 1) * (n // parts)))
        return tuple(out)

    def shard(self, x):
        """This rank's block of the global array ``x``."""
        return x[self.block(x.shape)]


def frame_sharding(mesh: Optional[DeviceMesh]) -> Sharding:
    """Batch-of-frames arrays: frames over dp, points over sp."""
    return Sharding(mesh, ("dp", "sp"))


def replicated(mesh: Optional[DeviceMesh]) -> Sharding:
    return Sharding(mesh, ())


def all_reduce(tensors: Sequence[torch.Tensor], grp, op: str = "sum") -> list:
    """The tensors reduced over ``grp`` by one ``all_reduce`` of one flat
    float32 buffer ("sum" or "min"); each comes back in its own shape and
    dtype. Counts carried as float32 are exact below 2**24. ``grp=None``
    returns the inputs."""
    if grp is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=_OPS[op], group=grp)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def pmean(tensors: Sequence[torch.Tensor], grp) -> list:
    """JAX's ``pmean``: the sum over ``grp``, divided by the group size (a
    true float32 division by a tensor)."""
    if grp is None:
        return list(tensors)
    summed = all_reduce(tensors, grp)
    n = const(float(dist.get_world_size(grp)), summed[0])
    return [t / n for t in summed]
