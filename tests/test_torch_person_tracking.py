"""The port's pyramidal LK (``ops/lk.py``) and person tracker
(``models/tracking.py``) against the JAX package on the CPU.

Same numpy inputs through both (the JAX functions jitted, as their tests
call them). Tolerances:

- ``build_pyramid`` against the jitted JAX function's: within 3e-5, an
  ulp at 200 (the port adds each 2x2 block in row-major order; XLA picks
  its order by size and fusion, row-major for 120x160 alone but not
  always for the smaller levels);
- ``lk_track`` on ``tests/test_triangulate_stereo_lk.py``'s and
  ``tests/test_tracking.py``'s textures (a small shift, a large one that
  needs the pyramid, a flat region): the same validity, points within
  1e-3 px, window errors within 1e-3;
- ``tracker_step`` on ``tests/test_tracking.py``'s cases (fresh ids, ids
  kept through motion and a swapped detection order, a far detection,
  a track kept by LK alone, smoothing at 0.7 over 14 noisy frames) and on
  the first frames of ``chip_smoke.person_scene`` (8 BODY_25 people and 4
  padding rows at ``TrackerConfig()``): ids, slots and ``next_id`` equal,
  keypoints within 1e-3 px, keypoint masks equal;
- the slot collision of the JAX function: with two slots, a padding row
  after a detection matched to the last slot undoes that match on the
  CPU (XLA applies duplicate scatter indices in order); the port gives
  the same result on purpose.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import chip_smoke  # noqa: E402
from test_tracking import person, textured  # noqa: E402  (the JAX package's test scene)

from perception_tpu.models import tracking as jtr  # noqa: E402
from perception_tpu.ops import lk as jlk  # noqa: E402
from perception_tpu_torch.convert import person_tracks_from_jax  # noqa: E402
from perception_tpu_torch.models import tracking  # noqa: E402
from perception_tpu_torch.ops import lk  # noqa: E402

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


def test_pyramid_matches_jax():
    img = textured(1)
    want = jax.jit(jlk.build_pyramid, static_argnums=1)(jnp.asarray(img), 3)  # jitted, as lk_track runs it
    for got, w in zip(lk.build_pyramid(T(img), 3), want):
        np.testing.assert_allclose(np_of(got), np.asarray(w), rtol=0, atol=3e-5)
    odd = np.random.default_rng(0).random((37, 51), dtype=np.float32) * 200
    for x in (img, odd):
        np.testing.assert_allclose(np_of(lk._downsample2(T(x))),
                                   np.asarray(jax.jit(jlk._downsample2)(jnp.asarray(x))), rtol=0, atol=3e-5)


def lk_cases():
    rng = np.random.default_rng(1)
    img = textured(0)
    pts = np.stack([rng.uniform(20, 140, 40), rng.uniform(20, 100, 40)], -1).astype(np.float32)
    mask = rng.random(40) > 0.1
    flat = np.full((120, 160), 100.0, np.float32)
    return [
        ("shift", img, np.roll(img, (2, 3), axis=(0, 1)), pts, mask, 3),
        ("large", img, np.roll(img, 11, axis=1), pts, mask, 3),
        ("one level", img, np.roll(img, 1, axis=0), pts, mask, 1),
        ("flat", flat, flat, pts[:5], np.ones(5, bool), 3),
    ]


@pytest.mark.parametrize("name,img0,img1,pts,mask,levels", lk_cases(), ids=[c[0] for c in lk_cases()])
def test_lk_track_matches_jax(name, img0, img1, pts, mask, levels):
    got = lk.lk_track(T(img0), T(img1), T(pts), T(mask), levels=levels)
    want = jlk.lk_track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(mask), levels=levels)
    np.testing.assert_array_equal(np_of(got.valid), np.asarray(want.valid))
    np.testing.assert_allclose(np_of(got.points), np.asarray(want.points), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np_of(got.error), np.asarray(want.error), rtol=0, atol=1e-3)
    if name == "flat":
        assert not np_of(got.valid).any()
    if name == "shift":
        v = np_of(got.valid)
        assert v.sum() > 20
        np.testing.assert_allclose(np_of(got.points)[v], pts[v] + [3, 2], atol=0.1)


def step_both(state, jstate, prev, img, dets, mask, cfg):
    """One tracker_step of each package on the same inputs; checks and
    returns (state, jax state, ids)."""
    state, ids = tracking.tracker_step(state, T(prev), T(img), T(dets), T(mask), cfg)
    jstate, jids = jtr.tracker_step(jstate, jnp.asarray(prev), jnp.asarray(img), jnp.asarray(dets),
                                    jnp.asarray(mask), jtr.TrackerConfig(**cfg.__dict__))
    np.testing.assert_array_equal(np_of(ids), np.asarray(jids))
    np.testing.assert_array_equal(np_of(state.ids), np.asarray(jstate.ids))
    assert int(state.next_id) == int(jstate.next_id)
    np.testing.assert_array_equal(np_of(state.kp_mask), np.asarray(jstate.kp_mask))
    np.testing.assert_allclose(np_of(state.keypoints), np.asarray(jstate.keypoints), rtol=0, atol=1e-3)
    return state, jstate, np_of(ids)


def small_cfg(**kw):
    return tracking.TrackerConfig(max_tracks=8, num_parts=5, match_threshold_px=20.0, min_shared_parts=3, **kw)


def test_tracker_cases_match_jax():
    cfg = small_cfg()
    img0, img1 = textured(0), np.roll(textured(0), 3, axis=1)
    s, js = tracking.tracker_init(cfg, "cpu"), jtr.tracker_init(jtr.TrackerConfig(**cfg.__dict__))
    two = np.stack([person(40, 30), person(100, 40)])
    s, js, ids0 = step_both(s, js, img0, img0, two, np.ones(2, bool), cfg)
    assert set(ids0.tolist()) == {0, 1}
    swapped = np.stack([person(103, 40), person(43, 30)])
    s, js, ids1 = step_both(s, js, img0, img1, swapped, np.ones(2, bool), cfg)
    assert ids1.tolist() == ids0[::-1].tolist() and int(s.next_id) == 2
    s, js, ids2 = step_both(s, js, img1, img1, person(150, 100)[None], np.ones(1, bool), cfg)  # far: a new id
    assert ids2.tolist() == [2]
    s, js, ids3 = step_both(s, js, img1, img1, np.zeros((1, 5, 3), np.float32), np.zeros(1, bool), cfg)
    assert ids3.tolist() == [-1] and int((np_of(s.ids) >= 0).sum()) == 3  # kept by LK
    converted = person_tracks_from_jax(tracking.TrackState(*(np.asarray(x) for x in js)), device="cpu")
    for a, b in zip(converted, s):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=0, atol=1e-3)


def test_tracker_smoothing_matches_jax():
    """``tests/test_tracking.py``'s smoothing run at alpha 0.7."""
    base = textured(0)
    cfg = tracking.TrackerConfig(max_tracks=4, num_parts=5, match_threshold_px=25.0, min_shared_parts=3,
                                 smooth_alpha=0.7)
    s, js = tracking.tracker_init(cfg, "cpu"), jtr.tracker_init(jtr.TrackerConfig(**cfg.__dict__))
    prev, rng = base, np.random.RandomState(7)
    for t in range(14):
        img = np.roll(base, int(round(2.0 * (t + 1))), axis=1)
        det = person(40.0 + 2.0 * (t + 1), 30.0)
        det[:, :2] += rng.randn(5, 2) * 3.0
        s, js, ids = step_both(s, js, prev, img, det[None], np.ones(1, bool), cfg)
        assert ids.tolist() == [0]
        prev = img


def test_tracker_on_the_smoke_scene_matches_jax():
    grays, dets, masks, _ = chip_smoke.person_scene(frames=4)
    cfg = tracking.TrackerConfig()
    s, js = tracking.tracker_init(cfg, "cpu"), jtr.tracker_init(jtr.TrackerConfig())
    for t in range(4):
        s, js, ids = step_both(s, js, grays[max(t - 1, 0)], grays[t], dets[t], masks[t], cfg)
    assert int(s.next_id) == chip_smoke.PERSON_COUNT and sorted(ids[ids >= 0].tolist()) == list(range(8))


@pytest.mark.parametrize("mask", [[True, True], [True, True, False]], ids=["no padding", "padding row"])
def test_slot_collision_matches_jax(mask):
    """Two slots; frame 0 places people at x=40 and x=100, frame 1 detects
    them at 43 and 105. Without padding the slots take (43, 105); a padding
    row after them aims at slot 1 too, writes its old values back and
    leaves it its LK propagation (100 on an unmoved image): (43, 100)."""
    cfg = tracking.TrackerConfig(max_tracks=2, num_parts=5)
    img = textured(0)
    s, js = tracking.tracker_init(cfg, "cpu"), jtr.tracker_init(jtr.TrackerConfig(**cfg.__dict__))
    s, js, _ = step_both(s, js, img, img, np.stack([person(40, 30), person(100, 40)]), np.ones(2, bool), cfg)
    dets = np.zeros((len(mask), 5, 3), np.float32)
    dets[:2] = np.stack([person(43, 30), person(105, 40)])
    s, js, ids = step_both(s, js, img, img, dets, np.array(mask), cfg)
    x = np_of(s.keypoints)[:, 0, 0]
    if len(mask) == 2:
        np.testing.assert_allclose(x, [43.0, 105.0], atol=1e-3)
    else:
        np.testing.assert_allclose(x, [43.0, 100.0], atol=1e-2)
    assert ids[:2].tolist() == [0, 1]
