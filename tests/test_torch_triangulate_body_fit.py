"""The port's triangulation and body-model fit against the JAX package.

Scenes: ``tests/test_triangulate_stereo_lk.py``'s camera ring and
``tests/test_body_fit.py``'s synthetic skeletons (numpy, seeded).

Tolerances:
- DLT and Gauss-Newton points within 1e-4 m, ``valid`` equal, mean
  reprojection error within 1e-3 px (float32 eigh and 3x3 solves of
  LAPACK against XLA's; measured 3e-6 m);
- forward kinematics within 1e-6 m;
- ``fit_body`` on well-conditioned people: the same LM accept pattern
  (the JAX package's read from its damping trajectory), observed joints
  within 1e-4 m, the mean residual within 1e-5 m; where the float32 LM
  amplifies rounding (``test_fit_body_sensitive_cases``), within 1 mm and
  1e-4 m;
- the batched fit over people equal, bit for bit, to the fit one person
  at a time (its J^T r is a row-vector product, which rounds alike at any
  batch size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.geometry import se3 as jse3
from perception_tpu.models import body_fit as jbf
from perception_tpu.ops import triangulate as jtri
from perception_tpu_torch.models import body_fit as bf
from perception_tpu_torch.ops import triangulate as tri
from test_triangulate_stereo_lk import camera_ring

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def ring_scene(cams, n, noise, seed, drop=0.0):
    rng = np.random.RandomState(seed)
    P = camera_ring(cams)
    X = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    proj = np.einsum("cij,nj->nci", P, np.concatenate([X, np.ones((n, 1))], 1))
    uv = (proj[..., :2] / proj[..., 2:] + rng.randn(n, cams, 2) * noise).astype(np.float32)
    mask = rng.rand(n, cams) >= drop
    mask[:3, 1:] = False  # one view only: never valid
    return P, uv, mask, X


@pytest.mark.parametrize("cams,noise,seed,drop", [(4, 0.0, 0, 0.0), (6, 1.0, 1, 0.1), (4, 2.0, 2, 0.25)])
def test_triangulation_matches(cams, noise, seed, drop):
    P, uv, mask, X = ring_scene(cams, 80, noise, seed, drop)
    args = (P, uv, mask)
    jd = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in args)))
    d = tri.triangulate_dlt(*(_t(a) for a in args)).numpy()
    ok = mask.sum(1) >= 2
    np.testing.assert_allclose(d[ok], jd[ok], rtol=0, atol=1e-4)
    jr = jtri.triangulate(*(jnp.asarray(a) for a in args))
    r = tri.triangulate(*(_t(a) for a in args))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(jr.valid))
    v = np.asarray(jr.valid)
    np.testing.assert_allclose(r.points.numpy()[v], np.asarray(jr.points)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.reproj_error.numpy()[v], np.asarray(jr.reproj_error)[v], rtol=0, atol=1e-3)
    assert not r.valid[:3].any()
    err = np.linalg.norm(r.points.numpy()[v] - X[v], axis=1).mean()
    assert err < 0.03


def test_triangulation_iterations_and_mask():
    P, uv, mask, X = ring_scene(4, 5, 0.0, 3)
    uv[:, 2] += 300.0
    mask[:, 2] = False
    mask[:3] = True
    mask[:3, 2] = False
    for it in (1, 8):
        jr = jtri.triangulate(jnp.asarray(P), jnp.asarray(uv), jnp.asarray(mask), iterations=it)
        r = tri.triangulate(_t(P), _t(uv), _t(mask), iterations=it)
        np.testing.assert_allclose(r.points.numpy(), np.asarray(jr.points), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.points.numpy(), X, atol=1e-3)


def skeleton(seed, scale, angle_range=0.5):
    model = jbf.BodyModel.body15()
    rng = np.random.default_rng(seed)
    angles = np.zeros((15, 3), np.float32)
    for j in (4, 7, 10, 13):
        angles[j] = rng.uniform(-angle_range, angle_range, 3)
    T = jse3.se3_exp(jnp.asarray(np.array([0.2, -0.3, 1.1, 0.1, 0.3, -0.2], np.float32)))
    return np.asarray(T), angles, np.asarray(jbf.forward_kinematics(model, T, jnp.asarray(angles), scale))


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.2), (2, 0.9)])
def test_forward_kinematics_matches(seed, scale):
    T, angles, joints = skeleton(seed, scale)
    rng = np.random.RandomState(seed)
    angles = angles + rng.randn(15, 3).astype(np.float32) * 0.3
    want = np.asarray(jbf.forward_kinematics(jbf.BodyModel.body15(), jnp.asarray(T), jnp.asarray(angles), scale))
    got = bf.forward_kinematics(bf.BodyModel.body15(), _t(T), _t(angles), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_model_constants_equal():
    for name in ("BODY15_PARENTS", "BODY15_BONE_DIRS", "BODY15_BONE_LENGTHS", "BODY15_TO_BODY25"):
        np.testing.assert_array_equal(getattr(bf, name), getattr(jbf, name))
    assert bf.BODY15_NAMES == jbf.BODY15_NAMES


def _jax_fit_with_accepts(obs, mask, iterations, monkeypatch):
    """The JAX fit, called as its test calls it eagerly, with its LM scan's
    damping after each step recorded; a step was accepted where the damping
    fell (or stayed at its floor)."""
    real_scan = jax.lax.scan
    lams = []

    def spy(f, init, xs=None, length=None, **kw):
        if xs is not None:  # forward kinematics' scan
            return real_scan(f, init, xs, length=length, **kw)

        def g(c, x):
            c2, _ = f(c, x)
            return c2, c2[1]

        out, lam = real_scan(g, init, xs, length=length, **kw)
        lams.append(lam)
        return out, None

    monkeypatch.setattr(jax.lax, "scan", spy)
    res = jbf.fit_body(jnp.asarray(obs), jnp.asarray(mask), iterations=iterations)
    monkeypatch.setattr(jax.lax, "scan", real_scan)
    lam = np.asarray(lams[0])
    prev = np.concatenate([[np.float32(1e-3)], lam[:-1]])
    return res, (lam < prev) | ((lam == prev) & (lam <= 1e-6))


def _fit_pair(seed, noise, scale, masked, monkeypatch, iterations=30):
    _, _, joints = skeleton(seed, scale)
    obs = (joints + np.random.RandomState(seed).randn(15, 3) * noise).astype(np.float32)
    mask = np.ones(15, bool)
    mask[list(masked)] = False
    jres, jacc = _jax_fit_with_accepts(obs, mask, iterations, monkeypatch)
    res = bf.fit_body(_t(obs), _t(mask), iterations=iterations)
    return res, jres, jacc, mask


@pytest.mark.parametrize("seed,noise,scale", [(0, 0.0, 1.05), (5, 0.01, 0.95)])
def test_fit_body_matches(seed, noise, scale, monkeypatch):
    res, jres, jacc, mask = _fit_pair(seed, noise, scale, (), monkeypatch)
    np.testing.assert_array_equal(res.accepted.numpy(), jacc)
    got, want = res.joints.numpy(), np.asarray(jres.joints)
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(res.residual), float(jres.residual), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(res.scale), float(jres.scale), rtol=0, atol=1e-4)
    assert float(res.residual) < 0.02


@pytest.mark.parametrize("seed,noise,scale,masked", [(3, 0.0, 1.0, ()), (3, 0.0, 1.0, (5,)),
                                                     (7, 0.005, 1.1, ()), (7, 0.005, 1.1, (14,))])
def test_fit_body_sensitive_cases(seed, noise, scale, masked, monkeypatch):
    """Fits whose float32 LM steps amplify rounding: a leaf joint's own
    angle, and a masked leaf's parent angle, are held only by the 1e-3
    angle prior, so the normal equations have directions ~1e-6 of their
    largest. There the JAX package differs from itself by up to 2.9 mm
    (the same person alone and in a vmap over three, on the batch scene
    below), and at 30 steps the two accept patterns part (at seed 3 with
    joint 5 masked the port is still at 8.6 mm of residual where the JAX
    package is at 0.04 mm). After 60 steps both have converged: the port
    is held to 1 mm of the JAX package's joints and 1e-4 m of its
    residual."""
    res, jres, jacc, mask = _fit_pair(seed, noise, scale, masked, monkeypatch, iterations=60)
    np.testing.assert_allclose(res.joints.numpy()[mask], np.asarray(jres.joints)[mask], rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(res.residual), float(jres.residual), rtol=0, atol=1e-4)


def test_fit_body_batched_equals_one_at_a_time():
    people = []
    for seed in range(3):
        _, _, joints = skeleton(seed + 10, 1.0 + 0.05 * seed)
        kp = np.zeros((25, 3), np.float32)
        kp[bf.BODY15_TO_BODY25] = joints + np.random.RandomState(seed).randn(15, 3) * 0.005
        conf = np.zeros(25, np.float32)
        conf[bf.BODY15_TO_BODY25] = 0.9
        conf[bf.BODY15_TO_BODY25[5 + seed]] = 0.01  # one joint under the threshold
        people.append((kp, conf))
    kps, confs = (np.stack(x) for x in zip(*people))
    batch = bf.fit_body_from_body25(_t(kps), _t(confs), iterations=20)
    assert batch.joints.shape == (3, 15, 3) and batch.accepted.shape == (3, 20)
    for p in range(3):
        one = bf.fit_body_from_body25(_t(kps[p]), _t(confs[p]), iterations=20)
        np.testing.assert_array_equal(batch.joints[p].numpy(), one.joints.numpy())
        np.testing.assert_array_equal(batch.accepted[p].numpy(), one.accepted.numpy())
    jbatch = jax.vmap(lambda k, c: jbf.fit_body_from_body25(k, c, iterations=20))(jnp.asarray(kps), jnp.asarray(confs))
    sel = np.stack([confs[p][bf.BODY15_TO_BODY25] > 0.05 for p in range(3)])
    # The JAX package's vmap against its own one-person calls: up to 2.9 mm
    # here (test_fit_body_sensitive_cases); the port is held to 5 mm of it
    # and to 0.5 mm of its residual.
    np.testing.assert_allclose(batch.joints.numpy()[sel], np.asarray(jbatch.joints)[sel], rtol=0, atol=5e-3)
    np.testing.assert_allclose(batch.residual.numpy(), np.asarray(jbatch.residual), rtol=0, atol=5e-4)
