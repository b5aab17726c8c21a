"""Stage profiling + structured metrics.

Counterpart of ``perception_tpu/utils/profiler.py``:

  * ``StageTimer``: a named walltime accumulator that waits for the
    device work of a stage's result before it stops the clock (the JAX
    package's ``block_until_ready``), with print-every-X averaging;
  * ``MetricsLog``: a JSON-lines metrics emitter (``ts`` first, then the
    fields), to stdout or appended to a file;
  * ``trace``: a ``torch.profiler`` scope that writes a Chrome trace into
    ``log_dir``, in place of ``jax.profiler``.

The port's own additions, none of them in the JAX package:

  * ``span(name)``: a named host span inside the program's entries. It
    records only while a ``torch.profiler`` is active (``trace`` here, or
    any other profile); otherwise it costs one flag read. A recording span
    is also a ``record_function`` range, so ``trace``'s Chrome trace shows
    it around the operations it launched, and it appends one ``Span`` to a
    bounded in-memory buffer (``spans``, ``clear_spans``,
    ``spans_dropped``), stamped with ``time.perf_counter``;
  * ``counts_launches`` / ``count_launch``: the hand-written kernels'
    launch counters (``<wrapper>.launches``, ``<wrapper>.launches_by_shape``),
    which also add each launch to the innermost recording span, and
    ``tallied``, a block whose launches go into a tally instead (a CUDA
    graph's capture; each replay counts the tally).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import Counter, defaultdict, deque
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

try:
    import resource

    _RUSAGE_THREAD = resource.RUSAGE_THREAD
except (ImportError, AttributeError):  # no per-thread resource usage on this OS
    _RUSAGE_THREAD = None


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


class Span(NamedTuple):
    """One finished span. ``unit`` is the id of the outermost span open on
    the thread when it began (its own id for an outermost span), shared
    by every span of one call into an entry; ``cpu_s`` is the thread's CPU
    time inside it, so ``t1 - t0 - cpu_s`` is the time the thread spent
    off the CPU (``time.thread_time``: where the OS counts CPU time by
    scheduler ticks, one span's reading moves in whole ticks, and only
    sums over many spans are fine-grained); ``nivcsw`` its involuntary
    context switches (None where the OS does not count them per thread);
    ``launches`` the hand-written kernels' launches made while it was the
    innermost span, by wrapper."""

    name: str
    id: int
    parent: Optional[int]
    unit: int
    t0: float
    t1: float
    cpu_s: float
    nivcsw: Optional[int]
    launches: Dict[str, int]


SPAN_CAPACITY = 2**20


class SpanBuffer:
    """The finished spans, oldest first; at ``capacity`` the oldest is
    dropped for each new one, and counted."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records = deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: Span) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)

    def copy(self) -> List[Span]:
        with self._lock:
            return list(self.records)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0


_BUFFER = SpanBuffer()
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's recording spans, innermost last


def _nivcsw() -> Optional[int]:
    if _RUSAGE_THREAD is None:
        return None
    return resource.getrusage(_RUSAGE_THREAD).ru_nivcsw


class _RecordingSpan:
    __slots__ = ("name", "id", "parent", "unit", "launches", "_range", "_t0", "_cpu0", "_sw0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent, self.unit = (stack[-1].id, stack[-1].unit) if stack else (None, self.id)
        self.launches = {}
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        # Wall clock outside the thread's CPU clock on both ends, so that
        # 0 <= cpu_s <= t1 - t0.
        self._sw0 = _nivcsw()
        self._t0 = time.perf_counter()
        self._cpu0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        cpu1 = time.thread_time()
        t1 = time.perf_counter()
        sw1 = _nivcsw()
        _open.stack.pop()
        self._range.__exit__(*exc)
        _BUFFER.add(Span(self.name, self.id, self.parent, self.unit, self._t0, t1, cpu1 - self._cpu0,
                         None if sw1 is None else sw1 - self._sw0, self.launches))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager timing the host inside ``name`` while a
    ``torch.profiler`` is active; otherwise a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordingSpan(name)


def spans() -> List[Span]:
    """A copy of the buffer's spans, in the order they finished."""
    return _BUFFER.copy()


def spans_dropped() -> int:
    """Spans dropped at the buffer's capacity since the last ``clear_spans``."""
    return _BUFFER.dropped


def clear_spans() -> None:
    _BUFFER.clear()


def counts_launches(wrapper):
    """Give a kernel wrapper its launch counters: ``wrapper.launches`` and
    ``wrapper.launches_by_shape`` (a Counter keyed by the launch's shape),
    which ``count_launch`` adds to and callers may reset."""
    wrapper.launches = 0
    wrapper.launches_by_shape = Counter()
    return wrapper


def count_launch(wrapper, shape, n: int = 1) -> None:
    """Count ``n`` launches of ``wrapper``'s kernel at ``shape``, also in
    the innermost recording span's ``launches`` under the wrapper's name;
    inside a ``tallied`` block, into its tally alone."""
    tally = getattr(_open, "tally", None)
    if tally is not None:
        tally[wrapper, shape] += n
        return
    wrapper.launches += n
    wrapper.launches_by_shape[shape] += n
    stack = getattr(_open, "stack", None)
    if stack:
        launches = stack[-1].launches
        launches[wrapper.__name__] = launches.get(wrapper.__name__, 0) + n


@contextlib.contextmanager
def tallied():
    """A Counter of the launches ``count_launch`` sees on this thread
    inside the block, by (wrapper, shape), which it counts nowhere else:
    a CUDA graph's capture records launches without running them, and each
    replay counts what its capture recorded."""
    saved = getattr(_open, "tally", None)
    _open.tally = tally = Counter()
    try:
        yield tally
    finally:
        _open.tally = saved
