"""Roofline accounting for a stage on the card.

Counterpart of ``perception_tpu/utils/roofline.py``: a stage's time, the
operations (and, where the caller gives them, the bytes) it needs, and
the share of the card's peaks that it reaches.

The JAX package reads both counts from XLA's compiled cost model
(``compiled.cost_analysis()``). torch has no counterpart of it: here
``cost_of`` counts the floating-point operations that
``torch.utils.flop_counter.FlopCounterMode`` sees while the stage runs
once (convolutions and matrix products, forward and backward, two
operations a multiply-add; elementwise operations and the hand-written
kernels' work are not counted), and bytes are ``None`` unless the caller
passes them. A caller that counts a stage from its shapes passes
``cost=(operations, bytes)`` instead (``bench/profile_stages.py``). The
peaks are the card's data sheet numbers; on the card the time comes from
CUDA events after a warm-up, on the CPU (only when asked for) from the
host clock, with no peaks and so no shares.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

# torch.cuda.get_device_name substring -> (f32 TFLOP/s outside the tensor
# cores, bf16 dense TFLOP/s, HBM GB/s): NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 part (67 / 989 / 3350), at its 700 W power limit.
_PEAKS = {
    "H100 80GB HBM3": (67.0, 989.0, 3350.0),
}


def device_peaks(device=None):
    """(f32_tflops, bf16_tflops, hbm_gbps) of a CUDA card, or None for
    another device or an unknown card."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    return None


@dataclasses.dataclass
class StageRoofline:
    name: str
    ms: float
    flops: Optional[float]             # the caller's count, else FlopCounterMode's
    bytes_accessed: Optional[float]    # the caller's, if given
    gflops_per_s: Optional[float] = None
    gbytes_per_s: Optional[float] = None
    mfu_f32_pct: Optional[float] = None    # achieved / f32 peak
    hbm_pct: Optional[float] = None        # achieved / HBM peak
    intensity: Optional[float] = None      # flops / byte
    bound: str = "unknown"
    terms: dict = dataclasses.field(default_factory=dict)     # the counted terms, by name
    launches: dict = dataclasses.field(default_factory=dict)  # kernel -> {shape: launches} in the timed calls

    def row(self) -> str:
        f = lambda v, fmt: (fmt % v) if v is not None else "    -"
        return (
            f"{self.name:<34} {self.ms:8.3f}  {f((self.flops or 0)/1e9, '%8.3f')} "
            f"{f((self.bytes_accessed or 0)/1e6, '%9.2f')} "
            f"{f(self.gflops_per_s, '%9.1f')} {f(self.gbytes_per_s, '%8.1f')} "
            f"{f(self.mfu_f32_pct, '%7.2f')} {f(self.hbm_pct, '%6.1f')} "
            f"{f(self.intensity, '%7.2f')}  {self.bound}"
        )


HEADER = (
    f"{'stage':<34} {'ms':>8}  {'GFLOP':>8} {'MB moved':>9} "
    f"{'GFLOP/s':>9} {'GB/s':>8} {'%f32':>7} {'%HBM':>6} {'FLOP/B':>7}  bound"
)


def cost_of(fn: Callable, *args, nbytes: Optional[float] = None) -> tuple:
    """(flops, bytes) of one call ``fn(*args)``: the operations
    ``FlopCounterMode`` counts (forward and, where ``fn`` runs it,
    backward), and ``nbytes`` as given (torch has no byte count)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops()), nbytes


def measure_stage(
    name: str,
    fn: Callable,
    *args,
    reps: int = 50,
    peaks=None,
    nbytes: Optional[float] = None,
    cost: Optional[tuple] = None,
    device="cuda",
) -> StageRoofline:
    """Steady-state time of ``fn(*args)`` (``reps`` calls after a warm-up
    call) + the operation count + utilisation against the card's peaks.
    On a CUDA ``device`` the time is CUDA events' (the card must be there);
    on the CPU the host clock's. ``cost=(operations, bytes)`` replaces
    ``cost_of``'s count and ``nbytes``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_stage times on a CUDA card; there is none")
        fn(*args)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        ms = (time.perf_counter() - t0) * 1e3 / reps

    flops, nbytes = cost if cost is not None else cost_of(fn, *args, nbytes=nbytes)
    st = StageRoofline(name=name, ms=ms, flops=flops, bytes_accessed=nbytes)
    if flops is not None:
        st.gflops_per_s = flops / (ms * 1e-3) / 1e9
    if nbytes is not None:
        st.gbytes_per_s = nbytes / (ms * 1e-3) / 1e9
    if flops and nbytes:
        st.intensity = flops / max(nbytes, 1.0)
    if peaks is None:
        peaks = device_peaks(device)
    if peaks and st.gflops_per_s is not None:
        f32_tf, _, hbm = peaks
        st.mfu_f32_pct = 100.0 * st.gflops_per_s / (f32_tf * 1e3)
        if st.gbytes_per_s is not None:
            st.hbm_pct = 100.0 * st.gbytes_per_s / hbm
        ridge = (f32_tf * 1e3) / hbm  # FLOP/byte where compute == bandwidth
        if st.hbm_pct is not None and st.hbm_pct > 40.0:
            st.bound = "HBM-bw"
        elif st.mfu_f32_pct > 40.0:
            st.bound = "f32"
        elif (st.intensity is not None and st.hbm_pct is not None and st.intensity < ridge
              and st.hbm_pct > 3 * st.mfu_f32_pct / ridge):
            st.bound = "bw-leaning"
        else:
            st.bound = "latency/serial"
    return st
