"""The port's SLAM odometry against the JAX package under the voxel-hash
map engine (kernel K3+K4's plain version here) with plain and
recency-weighted fusion, and under the exact segmented shortlist with a
mid-solve refresh and a coarse source stride. Scene and tolerances as in
``test_torch_odometry.py``, whose check this file runs.
"""

import pytest

from test_torch_odometry import check_run_against_jax, scene  # noqa: F401


@pytest.mark.parametrize("engine", ["map-hash", "map-hash-decay", "map-shortlist-exact-refresh-coarse"])
def test_run_odometry_matches_jax_under_the_other_map_engines(scene, engine):
    check_run_against_jax(scene, engine)
