"""Stage profiling + structured metrics.

Counterpart of ``perception_tpu/utils/profiler.py``:

  * ``StageTimer``: a named walltime accumulator that waits for the
    device work of a stage's result before it stops the clock (the JAX
    package's ``block_until_ready``), with print-every-X averaging;
  * ``MetricsLog``: a JSON-lines metrics emitter (``ts`` first, then the
    fields), to stdout or appended to a file;
  * ``trace``: a ``torch.profiler`` scope that writes a Chrome trace into
    ``log_dir``, in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def _synchronize(result: Any) -> None:
    """Wait for the devices of every CUDA tensor in ``result`` (tensors,
    and lists, tuples, dicts or NamedTuples of them)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self, print_every: int = 0):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.print_every = print_every

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        out = {}
        yield out
        # Drain device work attributed to this stage.
        _synchronize(out["result"] if "result" in out else result)
        dt = time.perf_counter() - t0
        self.total[name] += dt
        self.count[name] += 1
        if self.print_every and self.count[name] % self.print_every == 0:
            print(f"[profile] {name}: {self.mean_ms(name):.2f} ms avg over {self.count[name]}")

    def mean_ms(self, name: str) -> float:
        return self.total[name] / max(self.count[name], 1) * 1000.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.total}


class MetricsLog:
    """JSON-lines metrics sink (stdout or file)."""

    def __init__(self, path: Optional[str] = None):
        self.fh = open(path, "a") if path else None

    def emit(self, **fields) -> None:
        line = json.dumps({"ts": time.time(), **fields})
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()
        else:
            print(line)

    def close(self) -> None:
        if self.fh:
            self.fh.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope over the CPU and, where there is one, the CUDA
    card; writes ``trace.json`` (Chrome trace format) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
