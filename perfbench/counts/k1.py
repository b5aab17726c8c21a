"""K1, the fused RANSAC scoring kernel (``csrc/ransac_score.cu``).

Per (point, hypothesis) pair: 3 multiplies, 3 adds, the compare with
tau, the mask and the count, 9 float32 operations (the kernel forbids FMA
contraction). Bytes: the points (B, N, 3) float32, the mask (B, N) bool
and the hypotheses (B, K, 4) float32 read once, the counts (B, K) int32
written once.
"""

KERNELS = ("ransac_score_kernel",)


def ops(B: int, N: int, K: int) -> int:
    return 9 * B * N * K


def nbytes(B: int, N: int, K: int) -> int:
    return B * N * 12 + B * N + B * K * 16 + 4 * B * K
