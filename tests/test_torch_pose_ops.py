"""The port's resize, heatmap and PAF ops against the JAX package on the CPU.

Same numpy inputs through both. Tolerances:

- ``ops/resize`` against ``jax.image.resize`` / ``scale_and_translate``:
  the x8 upsample (46 -> 368, weights exact powers of two) within 1e-6;
  the antialiased downsample 480x640 -> 368x368 of a [0, 1] image within
  1e-5 (1/scale rounds to float32, and the two axes are contracted in
  another order); crops of a [0, 255] image, one box larger than the
  64 px crop (antialiased) and one partly outside the image, within 2e-4.
- PAF sampling: the port's gathers against JAX's ``_bilinear`` and
  ``_bilinear_mxu`` within 1e-6, coordinates past every border;
- ``nms_heatmap`` on the same maps: masks and integer peak positions
  equal, subpixel positions and scores within 1e-6. A 2x2 plateau gives
  one peak, at its raster-first pixel; more equal peaks than K keep the
  lower indices, as ``lax.top_k`` does.
- The decode on the JAX side's maps of the trained fixture
  (``tiny_posenet`` on two rendered scenes): ``paf_pair_scores`` within
  1e-5 with the same valid pairs, ``greedy_match`` equal, ``assemble_people``
  equal (limb-score means within 1e-6), and ``decode_people`` at
  ``paf_stride=1`` (PAFs upsampled to 128x128) and ``paf_stride=8`` (the
  stride-8 grid ``extract_people`` samples): the same people, part counts
  and peaks, keypoints within 1e-4 px, scores within 1e-5. XLA jits the
  JAX decode (FMAs, means as a sum times 1/n) and the port does not, so a
  sample's ``dots > 0.05`` or a pair's ``success >= 0.8`` could flip on
  an ulp; on these inputs none does, and the test asserts it.
- ``greedy_match`` with tied maxima takes the first index; ``keep_top_n_people``
  with tied scores keeps index order (stable ``argsort``); keypoint
  helpers within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from perception_tpu.models import pose as jpose
from perception_tpu.models import pose_fixture as jpf
from perception_tpu.models import topologies as jtopo
from perception_tpu.models.hand import crop_image as j_crop_image
from perception_tpu.ops import heatmap as jheatmap
from perception_tpu.ops import paf as jpaf
from perception_tpu.utils import keypoints as jkp
from perception_tpu_torch.models import pose, pose_fixture, topologies
from perception_tpu_torch.models.hand import crop_image
from perception_tpu_torch.ops import heatmap, paf
from perception_tpu_torch.ops.resize import resize
from perception_tpu_torch.utils import keypoints

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().cpu().numpy()


# --- resize ----------------------------------------------------------------

def test_resize_upsamples_by_8_like_jax():
    m = np.random.default_rng(0).random((26, 46, 46), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (26, 368, 368), "bilinear"))
    np.testing.assert_allclose(np_of(resize(T(m), (368, 368))), want, rtol=0, atol=1e-6)
    # resize_and_merge over two scales of (2, 8, 12) maps.
    two = np.random.default_rng(8).random((2, 3, 8, 12), dtype=np.float32)
    np.testing.assert_allclose(np_of(heatmap.resize_and_merge(T(two), (64, 96))),
                               np.asarray(jheatmap.resize_and_merge(jnp.asarray(two), (64, 96))), rtol=0, atol=1e-6)


def test_resize_antialiased_downsample_like_jax():
    img = np.random.default_rng(1).random((480, 640, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (368, 368, 3), "bilinear"))
    got = np_of(resize(T(img).permute(2, 0, 1), (368, 368)).permute(1, 2, 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Antialiasing matters here: a plain bilinear sample differs by far more.
    plain = torch.nn.functional.interpolate(T(img).permute(2, 0, 1)[None], (368, 368), mode="bilinear",
                                            align_corners=False)[0].permute(1, 2, 0)
    assert np.abs(np_of(plain) - want).max() > 0.05


@pytest.mark.parametrize("box", [(10.3, 5.7, 90.2, 85.6), (30.0, 20.0, 50.0, 40.0), (-10.0, -5.0, 120.0, 110.0)])
@pytest.mark.parametrize("channels", [0, 3])
def test_crop_image_matches_jax(box, channels):
    rng = np.random.default_rng(2)
    img = (rng.random((96, 96) + ((channels,) if channels else ()), dtype=np.float32) * 255).astype(np.float32)
    b = np.asarray(box, np.float32)
    want = np.asarray(j_crop_image(jnp.asarray(img), jnp.asarray(b), 64))
    got = np_of(crop_image(T(img), T(b), 64))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # Boxes batched on a leading axis give each box's crop.
    two = np_of(crop_image(T(img), T(np.stack([b, b + 3.0])), 64))
    np.testing.assert_array_equal(two[0], got)


# --- NMS -------------------------------------------------------------------

def nms_both(hm, threshold, k):
    want = jheatmap.nms_heatmap(jnp.asarray(hm), threshold=threshold, max_peaks=k)
    got = heatmap.nms_heatmap(T(hm), threshold=threshold, max_peaks=k)
    return got, want


def assert_same_peaks(got, want):
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(np.floor(np_of(got.xy) + 0.5), np.floor(np.asarray(want.xy) + 0.5))
    np.testing.assert_allclose(np_of(got.xy), np.asarray(want.xy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(got.score), np.asarray(want.score), rtol=0, atol=1e-6)


def test_nms_on_gaussian_peaks_matches_jax():
    rng = np.random.default_rng(3)
    centers = rng.uniform(3, 60, (6, 2)).astype(np.float32)
    g = np.asarray(jheatmap.gaussian_heatmap((64, 72), jnp.asarray(centers), sigma=2.0))
    np.testing.assert_allclose(np_of(heatmap.gaussian_heatmap((64, 72), T(centers), sigma=2.0)), g, atol=1e-6)
    hm = np.stack([g[:3].max(0), g[3:].max(0), g[0] * 0.04]) + rng.random((3, 64, 72), dtype=np.float32) * 0.01
    got, want = nms_both(hm, 0.05, 8)
    assert_same_peaks(got, want)
    assert np_of(got.mask).sum(1).tolist() == [3, 3, 0]


def test_nms_plateau_and_ties_keep_raster_order():
    hm = np.zeros((2, 16, 16), np.float32)
    hm[0, 5:7, 8:10] = 0.7           # a 2x2 plateau: one peak, at (x 8, y 5)
    hm[0, 12, 3] = 0.9
    for i in range(6):               # six equal isolated peaks, K = 4
        hm[1, 2 + 2 * (i // 3), 2 + 4 * (i % 3)] = 0.5
    got, want = nms_both(hm, 0.05, 4)
    assert_same_peaks(got, want)
    np.testing.assert_array_equal(np_of(got.mask)[0], [True, True, False, False])
    np.testing.assert_allclose(np_of(got.xy)[0, 1], [8.5, 5.5])   # plateau refined to its centre
    np.testing.assert_array_equal(np.floor(np_of(got.xy)[1]), [[2, 2], [6, 2], [10, 2], [2, 4]])
    # Batched maps give each frame's peaks.
    two = heatmap.nms_heatmap(T(np.stack([hm, hm[::-1].copy()])), threshold=0.05, max_peaks=4)
    np.testing.assert_array_equal(np_of(two.xy)[0], np_of(got.xy))
    np.testing.assert_array_equal(np_of(two.xy)[1, 0], np_of(got.xy)[1])


# --- PAF sampling -------------------------------------------------------------

def test_bilinear_matches_both_jax_samplers():
    """The port's gather form against JAX's gather form and its one-hot
    matmul form, with coordinates past every border (clamped to
    [0, size - 1.001])."""
    rng = np.random.default_rng(9)
    field = rng.standard_normal((2, 11, 17)).astype(np.float32)
    x = rng.uniform(-2.0, 19.0, 500).astype(np.float32)
    y = rng.uniform(-2.0, 13.0, 500).astype(np.float32)
    x[:3], y[:3] = [0.0, 15.999, 16.0], [0.0, 9.999, 10.0]
    got = np_of(paf._bilinear(T(field), T(x), T(y)))
    mxu = np.asarray(jpaf._bilinear_mxu(jnp.asarray(field), jnp.asarray(x), jnp.asarray(y)))
    gather = np.stack([np.asarray(jpaf._bilinear(jnp.asarray(f), jnp.asarray(x), jnp.asarray(y))) for f in field])
    np.testing.assert_allclose(got, mxu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, gather, rtol=0, atol=1e-6)


# --- decode on the fixture's maps -------------------------------------------

@pytest.fixture(scope="module")
def maps():
    """The JAX side's merged maps of the trained fixture on two scenes:
    PAFs on the stride-8 grid and upsampled, heatmaps at 128x128."""
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          serialization.msgpack_restore(jpf.FIXTURE_PATH.read_bytes()))
    _, images = pose_fixture.sample_scenes(np.random.default_rng(7), 2)
    pafs, hms = jpf.tiny_posenet().apply(params, jnp.asarray(images))
    pafs = jnp.transpose(pafs, (0, 3, 1, 2))
    hms = jax.image.resize(jnp.transpose(hms, (0, 3, 1, 2)), (2, 16, 128, 128), "bilinear")[:, :15]
    pafs_up = jax.image.resize(pafs, (2, 28, 128, 128), "bilinear")
    return np.asarray(pafs), np.asarray(pafs_up), np.asarray(hms)


PAIRS = jpose.MPI_15_PAIRS
DECODE = dict(num_parts=15, peak_threshold=0.2, min_person_parts=5)


def test_pair_scores_greedy_and_assembly_match_jax(maps):
    pafs, _, hms = maps
    for f in range(2):
        peaks = jheatmap.nms_heatmap(jnp.asarray(hms[f]), threshold=0.2, max_peaks=32)
        xy = np.asarray((peaks.xy + 0.5) / 8.0 - 0.5)
        mask = np.asarray(peaks.mask)
        want_s, got_s = [], []
        for l, (a, b) in enumerate(PAIRS):
            want_s.append(np.asarray(jpaf.paf_pair_scores(
                jnp.asarray(pafs[f, 2 * l]), jnp.asarray(pafs[f, 2 * l + 1]),
                jnp.asarray(xy[a]), jnp.asarray(mask[a]), jnp.asarray(xy[b]), jnp.asarray(mask[b]))))
            got_s.append(np_of(paf.paf_pair_scores(
                T(pafs[f, 2 * l]), T(pafs[f, 2 * l + 1]), T(xy[a]), T(mask[a]), T(xy[b]), T(mask[b]))))
        want_s, got_s = np.stack(want_s), np.stack(got_s)
        np.testing.assert_array_equal(got_s > -1, want_s > -1)
        assert (want_s > 0).sum() >= 10
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)

        want_m = jax.vmap(jpaf.greedy_match)(jnp.asarray(want_s))
        got_m = paf.greedy_match(T(want_s))
        for name in ("a_idx", "b_idx", "score", "mask"):
            np.testing.assert_array_equal(np_of(getattr(got_m, name)), np.asarray(getattr(want_m, name)))

        args = (want_m.a_idx, want_m.b_idx, want_m.score, want_m.mask, peaks.xy, peaks.score, peaks.mask)
        want_p = jpaf.assemble_people(jnp.asarray(PAIRS), *args, num_parts=15, max_peaks=32, min_person_parts=5)
        got_p = paf.assemble_people(T(PAIRS), *(T(np.asarray(a)) for a in args), num_parts=15, max_peaks=32,
                                    min_person_parts=5)
        assert np.asarray(want_p.mask).sum() >= 1
        assert_same_people(got_p, want_p, kp_atol=0.0, score_atol=1e-6)


def assert_same_people(got, want, kp_atol, score_atol):
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(np_of(got.num_parts), np.asarray(want.num_parts))
    kg, kw = np_of(got.keypoints), np.asarray(want.keypoints)
    np.testing.assert_array_equal(kg[..., 2] > 0, kw[..., 2] > 0)
    np.testing.assert_allclose(kg, kw, rtol=0, atol=kp_atol)
    np.testing.assert_allclose(np_of(got.score), np.asarray(want.score), rtol=0, atol=score_atol)


@pytest.mark.parametrize("stride", [1, 8])
def test_decode_people_matches_jax(maps, stride):
    pafs_s8, pafs_up, hms = maps
    pafs = pafs_s8 if stride == 8 else pafs_up
    for f in range(2):
        want = jpose.decode_people(jnp.asarray(pafs[f]), jnp.asarray(hms[f]), jnp.asarray(PAIRS),
                                   paf_stride=float(stride), **DECODE)
        got = pose.decode_people(T(pafs[f]), T(hms[f]), PAIRS, paf_stride=float(stride), **DECODE)
        assert np.asarray(want.mask).sum() >= 1
        assert_same_people(got, want, kp_atol=1e-4, score_atol=1e-5)
    # Both frames in one call give each frame's people.
    both = pose.decode_people(T(pafs), T(hms), PAIRS, paf_stride=float(stride), **DECODE)
    for f in range(2):
        one = pose.decode_people(T(pafs[f]), T(hms[f]), PAIRS, paf_stride=float(stride), **DECODE)
        for a, b in zip(both, one):
            np.testing.assert_array_equal(np_of(a[f]), np_of(b))


def test_greedy_match_ties_take_the_first_index():
    s = np.full((5, 4), -1.0, np.float32)
    s[1, 2] = s[3, 0] = s[0, 3] = 0.6   # tied maxima: (0, 3) first in raster order
    s[4, 1] = 0.2
    want = jpaf.greedy_match(jnp.asarray(s), max_connections=6)
    got = paf.greedy_match(T(s), max_connections=6)
    for name in ("a_idx", "b_idx", "score", "mask"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np.asarray(getattr(want, name)))
    assert np_of(got.a_idx)[:3].tolist() == [0, 1, 3]


def test_assemble_people_duplicates_and_masked_nodes_match_jax():
    """Random limb matches over sparse peaks: duplicated (person, part)
    slots max-combine per component; unmasked edges to masked peaks."""
    rng = np.random.default_rng(5)
    P, K, E = 15, 4, 4
    L = len(PAIRS)
    args = (
        rng.integers(0, K, (L, E)).astype(np.int32), rng.integers(0, K, (L, E)).astype(np.int32),
        rng.random((L, E), dtype=np.float32), rng.random((L, E)) > 0.3,
        rng.random((P, K, 2), dtype=np.float32) * 100, rng.random((P, K), dtype=np.float32),
        rng.random((P, K)) > 0.2,
    )
    want = jpaf.assemble_people(jnp.asarray(PAIRS), *map(jnp.asarray, args), num_parts=P, max_peaks=K,
                                max_people=6, min_person_parts=3)
    got = paf.assemble_people(T(PAIRS), *map(T, args), num_parts=P, max_peaks=K, max_people=6, min_person_parts=3)
    assert np.asarray(want.mask).sum() >= 1
    assert_same_people(got, want, kp_atol=0.0, score_atol=1e-6)


# --- keypoint helpers and topologies -----------------------------------------

def test_keypoint_helpers_match_jax():
    rng = np.random.default_rng(6)
    kp = (rng.random((6, 15, 3)) * [100, 80, 1]).astype(np.float32)
    kp[..., 2] *= rng.random((6, 15)) > 0.4
    kp[4, :, 2] = 0
    kp[5, 1:, 2] = 0
    scores = np.array([0.5, 0.9, 0.5, 0.7, 0.9, 0.1], np.float32)  # ties at 0.5 and 0.9
    mask = np.array([True, True, True, False, True, True])
    for n in (1, 3, 6):
        got = keypoints.keep_top_n_people(T(kp), T(scores), T(mask), n)
        want = jkp.keep_top_n_people(jnp.asarray(kp), jnp.asarray(scores), jnp.asarray(mask), n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_of(g), np.asarray(w))
    np.testing.assert_allclose(np_of(keypoints.keypoint_area(T(kp), 0.1)),
                               np.asarray(jkp.keypoint_area(jnp.asarray(kp), 0.1)), rtol=1e-6)
    for a, b in ((0, 1), (2, 4), (4, 5)):
        np.testing.assert_allclose(np_of(keypoints.keypoints_person_distance(T(kp[a]), T(kp[b]))),
                                   np.asarray(jkp.keypoints_person_distance(jnp.asarray(kp[a]), jnp.asarray(kp[b]))),
                                   rtol=1e-6)
    np.testing.assert_array_equal(np_of(keypoints.rescale_keypoints(T(kp), (0.5, 2.0))),
                                  np.asarray(jkp.rescale_keypoints(jnp.asarray(kp), jnp.asarray([0.5, 2.0]))))


def test_topologies_match_jax():
    assert topologies.FULL_ZOO.keys() == jtopo.FULL_ZOO.keys()
    for name, (parts, pairs) in jtopo.FULL_ZOO.items():
        got_parts, got_pairs = pose.lookup_topology(name)
        assert list(got_parts) == list(parts)
        np.testing.assert_array_equal(got_pairs, pairs)
    assert topologies.REFERENCE_NUM_PARTS == jtopo.REFERENCE_NUM_PARTS
    assert topologies.get_topology("BODY_135")[1].shape == jtopo.get_topology("BODY_135")[1].shape
