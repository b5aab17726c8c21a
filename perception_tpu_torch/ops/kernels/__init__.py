"""Hand-written CUDA kernels, each with its plain PyTorch version."""


def wrappers():
    """Every kernel's wrapper, by kernel name; each counts its launches
    (``launches``, ``launches_by_shape``). Imported on call: importing
    this package builds nothing."""
    from perception_tpu_torch.ops.kernels.icp_gn import gn_system_packed
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score
    from perception_tpu_torch.ops.kernels.voxelhash_query import voxelhash_query

    return {"ransac_score": ransac_score, "icp_gn": gn_system_packed, "voxelhash_query": voxelhash_query}
