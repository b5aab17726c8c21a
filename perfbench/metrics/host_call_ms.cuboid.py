"""host_call_ms.cuboid: host milliseconds inside the entry point, a unit of work
(traced run)."""

from perfbench.readers import entry_ms_per_unit


def read(ctx):
    return entry_ms_per_unit(ctx)
