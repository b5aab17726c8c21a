"""The multi-process runtime: process-group bootstrap, the global mesh,
host data in and out, and fleets of ranks spawned on one host.

Counterpart of ``perception_tpu/parallel/multihost.py``. Every process
runs the same program; ``initialize`` joins it into one
``torch.distributed`` process group (the ``jax.distributed.initialize``
handshake, here a TCP rendezvous at the coordinator's address), and
``global_mesh`` lays the (dp, sp) mesh over all ranks. Where JAX
assembles one global array from each process's slice, each rank here
keeps its own block (``shard_host_data``), and a replicated output is
brought to the host by gathering every rank's copy (``fetch_replicated``,
which also checks that the copies are bit-identical).

Ranks run on the card unless the caller asks for the CPU
(``device="cpu"``); asked for the card where there is none, ``initialize``
and ``run_fleet`` raise. The backend is the caller's choice, and nothing
falls back to another:
``"nccl"`` for one rank a card, ``"gloo"`` for CPU tensors or for several
ranks sharing one card (NCCL refuses two ranks on one GPU). A rank whose
``init_process_group`` or collective fails raises; ``run_fleet`` then
fails its caller.

``run_fleet`` spawns a fleet of ranks on this host (``spawn`` start
method), runs one function on each and returns their results: the form
the tests, ``parallel/scaling.py`` and ``parallel/dryrun.py`` use.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from perception_tpu_torch.parallel.mesh import Sharding, make_mesh


def _check_device(device: str, backend: str) -> None:
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda': no CUDA card (pass device='cpu' for CPU ranks)")
    if device == "cpu" and backend == "nccl":
        raise ValueError("nccl moves CUDA tensors only")


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: str = "gloo",
               device: str = "cuda", timeout_s: float = 600.0) -> torch.device:
    """Join this process into the process group as rank ``process_id`` of
    ``num_processes``, meeting at ``coordinator_address`` ("host:port").
    Returns this rank's device: the CPU, or for ``device="cuda"`` card
    ``process_id`` modulo the cards present (several gloo ranks may share
    one). (The JAX function takes ``local_device_count`` and
    ``cpu_collectives``; here ``backend`` and ``device``.)"""
    _check_device(device, backend)
    if device == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
                            **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def shutdown() -> None:
    """Leave the process group (the counterpart of the process exiting)."""
    dist.destroy_process_group()


def is_coordinator() -> bool:
    """True on the rank that does singleton side effects (rank 0)."""
    return dist.get_rank() == 0


def global_mesh(sp: Optional[int] = None, dp: Optional[int] = None) -> DeviceMesh:
    """The (dp, sp) mesh over all ranks. By default ``sp`` = 1 and ``dp``
    the world: one rank a process, as JAX's default puts a process's
    devices on ``sp`` and the processes on ``dp``."""
    n = dist.get_world_size()
    if sp is None:
        sp = 1 if dp is None else n // dp
    return make_mesh(dp if dp is not None else n // sp, sp)


def shard_host_data(mesh: DeviceMesh, spec, local_data, global_shape: Sequence[int], device=None) -> torch.Tensor:
    """This rank's block of a global array of ``global_shape`` sharded by
    ``spec``, from the block the process holds (``local_data``), on
    ``device``. The block's shape is checked against the sharding."""
    want = tuple(len(range(*s.indices(n))) for s, n in
                 zip(Sharding(mesh, tuple(spec)).block(global_shape), global_shape))
    want += tuple(global_shape[len(want):])
    x = torch.as_tensor(np.asarray(local_data), device=device)
    if tuple(x.shape) != want:
        raise ValueError(f"local block {tuple(x.shape)} is not this rank's block {want} of {tuple(global_shape)}")
    return x


def replicate_host_data(mesh: DeviceMesh, data, device=None) -> torch.Tensor:
    """A replicated array (the same ``data`` passed by every rank)."""
    return torch.as_tensor(np.asarray(data), device=device)


def fetch_replicated(x: torch.Tensor, grp=None) -> np.ndarray:
    """A replicated output on the host: every rank's copy gathered, checked
    bit-identical (raises if not), returned once."""
    n = dist.get_world_size(grp)
    copies = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(copies, x.contiguous(), group=grp)
    host = [c.cpu().numpy() for c in copies]
    for r, c in enumerate(host[1:], 1):
        if c.tobytes() != host[0].tobytes():
            raise RuntimeError(f"replicated output differs between rank 0 and rank {r}")
    return host[0]


def sync(name: str = "barrier") -> None:
    """Cross-rank barrier (``name`` only labels it, as in the JAX function)."""
    dist.barrier()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, device: str, threads: int, fn: Callable,
               args: tuple, results) -> None:
    torch.set_num_threads(threads)
    try:
        dev = initialize(f"127.0.0.1:{port}", world, rank, backend, device)
        results.put((rank, "ok", fn(rank, dev, *args)))
        shutdown()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_fleet(fn: Callable, world: int, args: Sequence[Any] = (), backend: str = "gloo", device: str = "cuda",
              timeout_s: float = 180.0, threads: int = 1) -> list:
    """Spawn ``world`` ranks on this host, run ``fn(rank, device, *args)``
    on each (``fn`` importable by name; its result picklable) in a process
    group of ``backend`` on ``device`` with ``threads`` torch threads a
    rank, and return the results in rank order. A rank that raises, exits or
    outlives ``timeout_s`` stops the fleet and raises here. Tensors in
    ``args`` reach the ranks in shared memory (torch's pickling for child
    processes): a rank that updates one in place updates every rank's."""
    _check_device(device, backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, threads, fn, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"fleet of {world} ({backend}, {device}): a rank exited with {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"fleet of {world} ({backend}, {device}): no result in {timeout_s} s")
                continue
            if status == "error":
                raise RuntimeError(f"fleet of {world} ({backend}, {device}): rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"fleet of {world} ({backend}, {device}): exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [got[r] for r in range(world)]
