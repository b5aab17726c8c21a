"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the reference,
each beside its limit, are the last lines of standard error. Exits 3
without a CUDA card (or with fewer than the cell asks for), and with
another code than 0 on any other failure, printing no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, in place of this script's folder, whose module
# names (trace, ...) would shadow the standard library's.
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.configure_caches()
    sys.exit(harness.main(sys.argv[1:], T_START))
