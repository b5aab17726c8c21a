"""K2, the fused Gauss-Newton ICP system (``csrc/icp_gn.cu``), one launch
of its three kernels (nearest neighbours, system, finish).

R restarts of Np packed source rows against Mp packed target rows
(``pack_source`` pads the source to a multiple of 512 rows,
``pack_target`` the target to a multiple of 1024): 10 operations a
(source, target) pair (3 multiplies and 3 adds for p.t - |t|^2/2, the
doubling, the subtraction, the compare, the select) and about 130 a
source row (transform, residual, weight, the 44 products of
w Jhat^T Jhat, the sums). Bytes: the packed source (R, Np, 8), the two
packed target tables (Mp, 8) and the poses (R, 4, 4) read once, the
system (R, 8, 8) and the stats (R, 2) written once.
"""

KERNELS = ("icp_gn_nn_kernel", "icp_gn_system_kernel", "icp_gn_finish_kernel")
LAUNCH_KERNEL = "icp_gn_finish_kernel"  # one per launch


def padded(point_budget: int, keyframe_budget: int):
    """(Np, Mp) of a keyframe-mode launch."""
    return -(-point_budget // 512) * 512, -(-keyframe_budget // 1024) * 1024


def ops(R: int, Np: int, Mp: int) -> int:
    return R * Np * (10 * Mp + 130)


def nbytes(R: int, Np: int, Mp: int) -> int:
    return 4 * (R * Np * 8 + 2 * Mp * 8 + R * 16) + 4 * R * 66
