"""The port's bench extras against the JAX package's ``benchmarks`` on the
CPU, and ``save_orbax`` / ``load_orbax`` against the JAX functions.

* ``bench/nn_crossover.measure`` against ``benchmarks/nn_crossover.measure``
  (the JAX side run as its tests run it: XLA's reference query on the CPU)
  at (512, 4096) and (1024, 65536), the second a table over 49152 rows
  (the 128-row alignment regime), 1 timed call each: the same keys and
  sizes, and ``agree_pct`` and ``agree_cold_pct`` equal (both 100).
* ``bench/tracking_bench.run(frames=6, width=160, height=120)`` against
  the JAX one. The RANSAC streams differ (``torch.Generator`` against
  ``jax.random``), so results are compared, not bits: the same keys, the
  same frame, object and resolution values, ``latched_pct`` equal and the
  median error within 1 mm.
* ``bench/facade_bench.run(frames=2)`` against the JAX one: the same keys
  and ``faces_tracked`` equal (3). The port draws the JAX benchmark's
  scene from the same keys, so its staged frames are the JAX frames within
  5e-3 of 255, ``test_torch_face.py``'s render tolerance (XLA fuses the
  stroke layers; the noise's normal draws agree within 2 ulps).
* ``save_orbax`` of a SLAM state (``test_checkpoint.py``'s
  ``small_state``) read back by the JAX ``load_orbax`` with ``orbax``
  hidden, and the JAX ``save_orbax`` (orbax hidden) read by the port's
  ``load_orbax``: every array bit-equal, at ``str(path) + ".npz"``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import facade_bench as jax_facade
from benchmarks import nn_crossover as jax_nn
from benchmarks import tracking_bench as jax_tracking
from perception_tpu.utils import checkpoint as jck
from perception_tpu_torch.bench import facade_bench, nn_crossover, tracking_bench
from perception_tpu_torch.convert import slam_state_from_jax
from perception_tpu_torch.utils import checkpoint
from test_checkpoint import small_state

torch.set_num_threads(2)

NN_SIZES = [(512, 4096), (1024, 65536)]


def test_nn_crossover_agrees_with_jax():
    got = nn_crossover.measure(sizes=NN_SIZES, iters=1, device="cpu")
    want = jax_nn.measure(sizes=NN_SIZES, iters=1)
    assert len(got) == len(want) == len(NN_SIZES)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["nq"], g["m"]) == (w["nq"], w["m"])
        assert g["agree_pct"] == w["agree_pct"] == 100.0
        assert g["agree_cold_pct"] == w["agree_cold_pct"] == 100.0


def test_tracking_bench_matches_jax():
    got = tracking_bench.run(frames=6, width=160, height=120, device="cpu")
    want = jax_tracking.run(frames=6, width=160, height=120)
    assert set(got) == set(want) and len(got) == 8
    for k in ("frames", "objects", "resolution"):
        assert got[k] == want[k]
    assert got["latched_pct"] == want["latched_pct"]
    assert abs(got["median_err_cm"] - want["median_err_cm"]) <= 0.1


def test_facade_frames_are_the_jax_scene():
    from perception_tpu.models import face_fixture as jff
    from perception_tpu.models.face_data import render_faces, sample_face_at

    key = jax.random.key(0)
    scenes = [sample_face_at(jax.random.fold_in(key, i), (256, 256), jff.FIXTURE_FX, jff.FIXTURE_FX, o,
                             facade_bench.Z) for i, o in enumerate(facade_bench.OFFSETS)]
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scenes)
    got = facade_bench.staged_frames()
    for t in (0, facade_bench.STAGED - 1):
        want = np.asarray(render_faces(stacked, (256, 256), key=jax.random.fold_in(key, 100 + t)))
        np.testing.assert_allclose(got[t, ..., 0], want, rtol=0, atol=5e-3)
        assert np.array_equal(got[t, ..., 0], got[t, ..., 2])


def test_facade_bench_matches_jax():
    got = facade_bench.run(frames=2, device="cpu")
    want = jax_facade.run(frames=2)
    assert set(got) == set(want) and len(got) == 5
    assert got["faces_tracked"] == want["faces_tracked"] == 3
    for k in ("frames", "resolution", "extractors"):
        assert got[k] == want[k]


@pytest.fixture
def no_orbax(monkeypatch):
    """Hide orbax, so the JAX functions take their npz fallback."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_save_orbax_reads_back_in_jax(no_orbax, tmp_path):
    state = jax.tree.map(np.asarray, small_state())
    checkpoint.save_orbax(tmp_path / "ckpt", slam_state_from_jax(state, device="cpu"))
    assert (tmp_path / "ckpt.npz").exists()
    back = jck.load_orbax(tmp_path / "ckpt", jax.tree.map(jnp.zeros_like, state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state), strict=True):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_save_orbax_loads_into_the_port(no_orbax, tmp_path):
    state = jax.tree.map(np.asarray, small_state())
    jck.save_orbax(tmp_path / "ckpt", state)
    assert (tmp_path / "ckpt.npz").exists()
    want = slam_state_from_jax(state, device="cpu")
    got = checkpoint.load_orbax(tmp_path / "ckpt", checkpoint._unflatten(
        want, iter([torch.zeros_like(t) for _, t in checkpoint._leaves(want)])))
    for (_, a), (_, b) in zip(checkpoint._leaves(got), checkpoint._leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
