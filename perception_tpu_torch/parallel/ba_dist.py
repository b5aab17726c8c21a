"""Distributed bundle adjustment: observation-sharded Schur reduction.

Counterpart of ``perception_tpu/parallel/ba_dist.py``. The observations
(the long axis) are split over every rank of the mesh; poses and
landmarks (small) are replicated. The solver is
``models/slam/backend.bundle_adjust`` with its ``reduce`` hook set to an
``all_reduce`` over the whole mesh, so one Levenberg-Marquardt iteration
is:

1. each rank builds the normal-equation blocks (Hpp, Hll, U, bp, bl) of
   its observations (``backend.ba_blocks``);
2. one ``all_reduce`` sums them;
3. the landmark elimination and the reduced (6M, 6M) solve
   (``backend.ba_schur_solve``, by Gauss-Jordan) run on every rank alike;
4. the accept test compares costs whose sums of squares are all-reduced
   (a one-float collective; the observation count is reduced once).

Every rank steps identically, so no broadcast is needed. Padding
observations carry ``obs_mask=False`` and add nothing. What differs from
the JAX step: the cost is ``bundle_adjust``'s, so observations behind
the camera (depth below 1 mm) add no residual and a step is kept only if
its cost is finite; and depth terms (``obs_z``, ``obs_zw``) are taken
where the problem has them.
"""

from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from perception_tpu_torch.models.slam.backend import BAProblem, BAResult, bundle_adjust
from perception_tpu_torch.parallel.mesh import all_reduce, group


def make_distributed_ba_step(
    mesh: Optional[DeviceMesh],
    M: int,
    L: int,
    iterations: int = 10,
    damping: float = 1e-3,
    huber_px: float = 3.0,
):
    """BA over ``mesh`` for a fixed (M poses, L landmarks) problem:
    ``step(problem, fx, fy, cx, cy) -> BAResult``, where ``problem`` holds
    the replicated poses and landmarks and this rank's block of the
    observations (the rows of axis 0 split over every mesh rank).
    ``mesh=None`` runs one rank holding every observation."""
    grp = group(mesh, None if mesh is None else tuple(mesh.mesh_dim_names))

    def step(problem: BAProblem, fx, fy, cx, cy) -> BAResult:
        if tuple(problem.poses_wc.shape[:1]) + tuple(problem.landmarks.shape[:1]) != (M, L):
            raise ValueError(f"problem of {problem.poses_wc.shape[0]} poses and {problem.landmarks.shape[0]} "
                             f"landmarks; the step was built for ({M}, {L})")
        return bundle_adjust(problem, fx, fy, cx, cy, iterations=iterations, damping=damping, huber_px=huber_px,
                             reduce=lambda tensors: all_reduce(tensors, grp))

    return step
