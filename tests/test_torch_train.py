"""The port's training path (``models/train.py``, ``utils/roofline.py``, the
fixture trainers' losses) against the JAX package's on the CPU.

Same numpy inputs through both. Tolerances:

- every ``make_optimizer`` kind, with a constant learning rate and with
  ``cosine_decay_schedule``, against optax over 5 updates of 50
  unit-scale parameters with gradients from 1e-4 to 1: within 1e-6 per
  element (torch's Adam rounds in another order: ~5e-7 after 5 updates);
  the schedule's values within 1e-7 relative of optax's;
- ``pose_loss`` on the same maps, with and without a mask: within 1e-6
  relative;
- one ``make_train_step`` step of ``test_train_hand.py``'s tiny PoseNet
  (widths (8, 8, 8), 32x32, the flax weights through
  ``posenet_from_flax``) against the jitted JAX step: loss within 1e-5
  relative, each gradient within 1e-5 of the largest gradient of its
  tensor; parameters after SGD (lr 0.1) within 1e-6. Adam's first update
  is about lr x sign(g); where |g| is below 1e-3 of the tensor's largest
  gradient (rounding can pick the sign there) an element is held within
  2 lr, elsewhere within 1e-6; the same for the second step, taken from
  the JAX state after the first through ``train_state_from_jax``
  (Adam's count, mu and nu; the SGD trace);
- ``posenet_to_flax`` inverts ``posenet_from_flax`` exactly;
- the JAX tests' behaviour repeated for the port: 30 Adam steps halve the
  tiny net's loss, ``snapshot``/``restore`` round-trip bit for bit, every
  optimizer kind builds, ``axis_name`` raises;
- ``torch.autograd.gradcheck`` in float64 of ``pose_loss`` through a tiny
  conv net (``test_gradcheck.py``'s), at its default tolerances;
- ``roofline.cost_of`` of one convolution equals the hand count
  2 N Cout H W Cin k^2, three times that with the backward pass;
- the face fixture trainer's loss against ``tools/train_face_fixture.py``'s
  on the committed fixture and one batch: within 1e-5 relative; the hand
  trainer's (MSE x 100) likewise; the hand trainer's loop (3 steps on the
  CPU) writes nothing over the committed fixture by default;
- the face trainer of both packages in lockstep
  (``tools_torch/face_trainer_compare.py``: the JAX ``init_tiny`` weights,
  the JAX tool's batch keys, Adam on the cosine schedule) for 4 steps of
  B=4: every step's losses within 5e-4 relative (the batches' renders
  differ by up to 5e-3 of 255, as ``test_torch_train_data.py`` holds
  them; 2.4e-5 to 5.6e-5 seen over the first 3 steps of B=16 from JAX
  keys 0 and 3; later steps part as rounding grows, as two JAX runs one
  ulp apart do).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from perception_tpu.models import train as jtrain
from perception_tpu.models.pose import PoseNet as JPoseNet
from perception_tpu_torch.convert import posenet_from_flax, posenet_to_flax, train_state_from_jax
from perception_tpu_torch.models import train
from perception_tpu_torch.models.pose import PoseNet
from perception_tpu_torch.utils import roofline

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools_torch"))

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def np_of(x):
    return x.detach().cpu().numpy()


class Vector(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.p = nn.Parameter(T(p))


def linear_loss(net, batch):
    return (net.p * batch["g"]).sum()  # its gradient is batch["g"]


def optax_updates(kind, lr, params, grads):
    opt = jtrain.make_optimizer(lr, kind)
    state = opt.init(jnp.asarray(params))
    p = jnp.asarray(params)
    out = []
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        out.append(np.asarray(p))
    return out


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("kind", train.KINDS)
def test_optimizer_matches_optax(kind, schedule):
    rng = np.random.default_rng(3)
    params = rng.normal(size=50).astype(np.float32)
    scales = np.logspace(-4, 0, 50).astype(np.float32)
    grads = [(rng.normal(size=50) * scales).astype(np.float32) for _ in range(5)]
    lr_j = optax.cosine_decay_schedule(1e-2, 5, alpha=0.05) if schedule else 1e-2
    lr_t = train.cosine_decay_schedule(1e-2, 5, alpha=0.05) if schedule else 1e-2
    want = optax_updates(kind, lr_j, params, grads)
    opt = train.make_optimizer(lr_t, kind)
    state = train.init_train_state(Vector(params), opt)
    step = train.make_train_step(opt, linear_loss)
    for g, w in zip(grads, want):
        state, _ = step(state, {"g": T(g)})
        np.testing.assert_allclose(np_of(state.params.p), w, rtol=0, atol=1e-6)
    assert state.step == 5


def test_cosine_schedule_matches_optax():
    j = optax.cosine_decay_schedule(2e-3, 600, alpha=0.05)
    t = train.cosine_decay_schedule(2e-3, 600, alpha=0.05)
    for c in (0, 1, 7, 299, 599, 600, 900):
        assert t(c) == pytest.approx(float(j(jnp.int32(c))), rel=1e-7)


def test_optimizer_zoo_and_axis_name():
    net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(4, 4, 4))
    for kind in train.KINDS:
        opt = train.make_optimizer(1e-3, kind)
        assert isinstance(opt.init(net.parameters()), torch.optim.Optimizer)
    with pytest.raises(ValueError):
        train.make_optimizer(1e-3, "lbfgs")
    with pytest.raises(NotImplementedError):
        train.make_train_step(train.make_optimizer(), axis_name="batch")


@pytest.mark.parametrize("masked", [False, True])
def test_pose_loss_matches_jax(masked):
    rng = np.random.default_rng(5)
    paf_p, paf_t = rng.normal(size=(2, 2, 6, 5, 4)).astype(np.float32)
    hm_p, hm_t = rng.normal(size=(2, 2, 6, 5, 3)).astype(np.float32)
    mask = (rng.random((2, 6, 5)) > 0.3).astype(np.float32)
    jbatch = {"image": None, "paf": jnp.asarray(paf_t), "heatmap": jnp.asarray(hm_t)}
    tbatch = {"image": None, "paf": T(paf_t).permute(0, 3, 1, 2), "heatmap": T(hm_t).permute(0, 3, 1, 2)}
    if masked:
        jbatch["mask"], tbatch["mask"] = jnp.asarray(mask), T(mask)
    want = jtrain.pose_loss(lambda p, x: (jnp.asarray(paf_p), jnp.asarray(hm_p)), None, jbatch)
    got = train.pose_loss(lambda x: (T(paf_p).permute(0, 3, 1, 2), T(hm_p).permute(0, 3, 1, 2)), tbatch)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# --- one step of the tiny PoseNet, JAX against the port -------------------

@pytest.fixture(scope="module")
def tiny():
    """test_train_hand.py's tiny PoseNet and batch, as numpy, and the flax
    params."""
    jnet = JPoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(8, 8, 8))
    rng = np.random.default_rng(0)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(0), jnp.asarray(img)))
    batch = {"image": img, "paf": (rng.normal(size=(2, 4, 4, 4)) * 0.1).astype(np.float32),
             "heatmap": (rng.normal(size=(2, 4, 4, 4)) * 0.1).astype(np.float32)}
    return jnet, params, batch


def port_net(params):
    net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(8, 8, 8))
    net.load_state_dict(posenet_from_flax(params, net, "cpu"), assign=True)
    return net


def port_batch(batch):
    return {k: T(v).permute(0, 3, 1, 2).contiguous() for k, v in batch.items()}


def jax_step(jnet, kind, lr):
    opt = jtrain.make_optimizer(lr, kind)
    return opt, jtrain.make_train_step(jnet.apply, opt)


def as_state_dict(tree, net):
    return {k: np_of(v) for k, v in posenet_from_flax(jax.tree.map(np.asarray, tree), net, "cpu").items()}


def assert_params_close(net, want, grads, lr, adam):
    """``want`` and ``grads`` as state dicts; Adam's small-gradient elements
    within 2 lr (module docstring)."""
    for name, p in net.named_parameters():
        got, w = np_of(p), want[name]
        if adam:
            g = np.abs(grads[name])
            small = g < 1e-3 * g.max()
            assert np.all(np.abs(got - w)[small] <= 2 * lr + 1e-6), name
            np.testing.assert_allclose(got[~small], w[~small], rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=name)


def test_posenet_to_flax_inverts_from_flax(tiny):
    _, params, _ = tiny
    back = posenet_to_flax(port_net(params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_loss_and_gradients_match_jax(tiny):
    jnet, params, batch = tiny
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.value_and_grad(lambda p: jtrain.pose_loss(jnet.apply, p, jb))(jax.tree.map(jnp.asarray, params))
    net = port_net(params)
    got = train.pose_loss(net, port_batch(batch))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    want = as_state_dict(grads, net)
    for name, p in net.named_parameters():
        g = np_of(p.grad)
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-5 * np.abs(want[name]).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("kind,lr", [("sgd", 0.1), ("momentum", 0.1), ("adam", 1e-3)])
def test_two_steps_match_jax(tiny, kind, lr):
    """A step from the flax weights, then a second from the JAX state after
    the first (``train_state_from_jax``): loss and parameters as stated."""
    jnet, params, batch = tiny
    jopt, jstep = jax_step(jnet, kind, lr)
    jb = jax.tree.map(jnp.asarray, batch)
    js1, jl1 = jstep(jtrain.init_train_state(jax.tree.map(jnp.asarray, params), jopt), jb)
    js2, jl2 = jstep(js1, jb)
    grads1 = jax.grad(lambda p: jtrain.pose_loss(jnet.apply, p, jb))(jax.tree.map(jnp.asarray, params))
    grads2 = jax.grad(lambda p: jtrain.pose_loss(jnet.apply, p, jb))(js1.params)

    opt = train.make_optimizer(lr, kind)
    step = train.make_train_step(opt)
    tb = port_batch(batch)
    state = train.init_train_state(port_net(params), opt)
    state, l1 = step(state, tb)
    assert float(l1) == pytest.approx(float(jl1), rel=1e-5)
    assert_params_close(state.params, as_state_dict(js1.params, state.params), as_state_dict(grads1, state.params),
                        lr, kind == "adam")

    cont = train_state_from_jax(jax.tree.map(np.asarray, js1), port_net(params), opt, device="cpu")
    assert cont.step == 1
    cont, l2 = step(cont, tb)
    assert cont.step == 2
    assert float(l2) == pytest.approx(float(jl2), rel=1e-5)
    assert_params_close(cont.params, as_state_dict(js2.params, cont.params), as_state_dict(grads2, cont.params),
                        lr, kind == "adam")


# --- the JAX tests' behaviour, for the port ---------------------------------

def small_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": T(rng.random((2, 3, 32, 32))), "paf": T(rng.normal(size=(2, 4, 4, 4)) * 0.1),
            "heatmap": T(rng.normal(size=(2, 4, 4, 4)) * 0.1)}


def test_train_step_reduces_loss():
    torch.manual_seed(0)
    net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(8, 8, 8))
    opt = train.make_optimizer(1e-3, "adam")
    state = train.init_train_state(net, opt)
    step = train.make_train_step(opt)
    batch = small_batch()
    losses = []
    for _ in range(30):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    assert state.step == 30


def test_snapshot_restore_roundtrip(tmp_path):
    def fresh(seed):
        torch.manual_seed(seed)
        net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(4, 4, 4))
        return train.init_train_state(net, train.make_optimizer(1e-3, "momentum"))

    state = fresh(0)
    step = train.make_train_step(train.make_optimizer(1e-3, "momentum"))
    for _ in range(3):
        state, _ = step(state, small_batch())
    train.snapshot(tmp_path / "ck", state)
    back = train.restore(tmp_path / "ck", fresh(1))
    assert back.step == 3
    for (n, a), (_, b) in zip(state.params.state_dict().items(), back.params.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = state.opt_state.state_dict()["state"], back.opt_state.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])


def test_gradcheck_pose_loss_float64():
    class Tiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 4, 3, padding=1)
            self.paf = nn.Conv2d(4, 2, 1)
            self.hm = nn.Conv2d(4, 3, 1)

        def forward(self, x):
            h = torch.relu(self.conv(x))
            return self.paf(h), self.hm(h)

    torch.manual_seed(3)
    net = Tiny().double()
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(rng.normal(size=(1, 3, 8, 8))),
             "paf": torch.from_numpy(rng.normal(size=(1, 2, 8, 8))),
             "heatmap": torch.from_numpy(rng.normal(size=(1, 3, 8, 8)))}
    names = [n for n, _ in net.named_parameters()]
    params = tuple(p.detach().clone().requires_grad_(True) for p in net.parameters())

    def f(*ps):
        return train.pose_loss(lambda x: torch.func.functional_call(net, dict(zip(names, ps)), (x,)), batch)

    assert torch.autograd.gradcheck(f, params)


def test_cost_of_counts_a_convolution():
    n, cin, cout, hw, k = 2, 3, 8, 16, 3
    conv = nn.Conv2d(cin, cout, k, padding=1)
    x = torch.zeros(n, cin, hw, hw)
    hand = 2 * n * cout * hw * hw * cin * k * k
    flops, nbytes = roofline.cost_of(conv, x)
    assert flops == hand and nbytes is None
    xg = x.clone().requires_grad_(True)
    flops, _ = roofline.cost_of(lambda: conv(xg).sum().backward())
    assert flops == 3 * hand
    assert roofline.device_peaks("cpu") is None
    st = roofline.StageRoofline("conv", 1.0, flops, None)
    assert st.row().startswith("conv")


# --- the fixture trainers' losses -------------------------------------------

def test_face_and_hand_losses_match_jax():
    from flax import serialization

    from perception_tpu.models import face_fixture as jff
    from perception_tpu.models import hand_fixture as jhf
    from perception_tpu.models.face import normalize_landmarks as jnorm
    from perception_tpu_torch.models import face_fixture, hand_fixture
    from train_face_fixture import face_loss
    from train_hand_fixture import hand_loss

    rng = np.random.default_rng(4)
    b = 2
    fb = {"crop": rng.random((b, 96, 96, 1), dtype=np.float32),
          "heatmaps": rng.random((b, 24, 24, 70), dtype=np.float32),
          "uv_crop": (rng.random((b, 70, 2)) * 96).astype(np.float32),
          "au": (rng.random((b, 17)) * 5).astype(np.float32),
          "image": (rng.random((b, 128, 128)) * 255).astype(np.float32),
          "det_heat": rng.random((b, 32, 32), dtype=np.float32),
          "det_size": rng.normal(size=(b, 32, 32)).astype(np.float32),
          "det_weight": rng.random((b, 32, 32), dtype=np.float32)}
    p = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                     serialization.msgpack_restore(jff.FIXTURE_PATH.read_bytes()))
    lm = jff.tiny_facenet().apply(p["landmark"], jnp.asarray(fb["crop"]))
    au = jax.vmap(lambda uv, t: jnp.mean((jff.tiny_au_head().apply(p["au"], jnorm(uv, jnp.ones(70, bool)))[0] - t) ** 2))(
        jnp.asarray(fb["uv_crop"]), jnp.asarray(fb["au"]))
    heat, size = jax.vmap(lambda im: jff.tiny_detector().apply(p["det"], im[..., None] / 255.0))(jnp.asarray(fb["image"]))
    w = fb["det_weight"]
    want = (jnp.mean((lm - fb["heatmaps"]) ** 2) * 100.0 + 0.1 * jnp.mean(au)
            + jnp.mean((heat - fb["det_heat"]) ** 2) * 20.0
            + 0.2 * jnp.sum(w * (size - fb["det_size"]) ** 2) / jnp.maximum(jnp.sum(w), 1.0))
    tb = {k: T(v) for k, v in fb.items()}
    tb["crop"] = tb["crop"].permute(0, 3, 1, 2)
    tb["heatmaps"] = tb["heatmaps"].permute(0, 3, 1, 2)
    got = face_loss(face_fixture.load_fixture("cpu"), tb)
    assert float(got) == pytest.approx(float(want), rel=1e-5)

    hp = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), serialization.msgpack_restore(jhf.FIXTURE_PATH.read_bytes()))
    crop = rng.random((b, 64, 64, 1), dtype=np.float32)
    maps = rng.random((b, 16, 16, 21), dtype=np.float32)
    want = jnp.mean((jhf.tiny_handnet().apply(hp, jnp.asarray(crop)) - maps) ** 2) * 100.0
    got = hand_loss(hand_fixture.load_fixture("cpu"), {"crop": T(crop).permute(0, 3, 1, 2),
                                                       "heatmaps": T(maps).permute(0, 3, 1, 2)})
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_hand_trainer_runs_on_the_cpu(tmp_path):
    from perception_tpu_torch.models import hand_fixture
    from train_hand_fixture import DEFAULT_OUT, parse_args, train as train_hand

    assert DEFAULT_OUT != hand_fixture.FIXTURE_PATH and parse_args([]).out == str(DEFAULT_OUT)
    out = tmp_path / "hand.msgpack"
    result = train_hand(parse_args(["--cpu", "--steps", "3", "--eval-every", "3", "--batch", "2", "--out", str(out)]),
                        log=lambda line: None)
    assert result["device"] == "cpu" and [s for s, _, _ in result["evals"]] == [3]
    assert np.isfinite(result["untrained_px"]) and result["s_per_step"] > 0
    assert np.isfinite(result["evals"][0][1])


def test_face_trainer_lockstep_with_jax():
    import face_trainer_compare

    args = face_trainer_compare.parse_args(["--steps", "4", "--batch", "4", "--log-every", "1", "--no-eval"])
    out = face_trainer_compare.run(args, log=lambda line: None)
    assert [r[0] for r in out["losses"]] == [1, 2, 3, 4]
    assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in out["losses"])
    assert out["max_loss_rel"] <= 5e-4, out["losses"]
