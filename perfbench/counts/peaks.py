"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

F32_FLOPS = 67e12      # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12    # bytes per second


def bound_s(ops: float, nbytes: float, flops: float = F32_FLOPS):
    """The least time in seconds for ``ops`` operations and ``nbytes``
    moved: (seconds, "operations" or "bytes", whichever sets it)."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
