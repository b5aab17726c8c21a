"""What a window records: completed units of work, their latencies, the
host time inside the program's entry point, and named host spans."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

now = time.perf_counter


@dataclasses.dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    units: int = 0                     # frames or steps whose result reached the host
    latencies: List[float] = dataclasses.field(default_factory=list)   # s, one per unit
    entry_s: float = 0.0               # host seconds inside the entry point
    spans: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)
    calls: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)  # start, end, units

    @property
    def seconds(self) -> float:
        return self.end - self.start
