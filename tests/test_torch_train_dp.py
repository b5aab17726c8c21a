"""The port's data-parallel training step (``models/train.make_train_step``
with ``axis_name``) on a gloo fleet of 2 ranks on the CPU, against the
JAX package's step on the same state (``convert.train_state_from_jax``)
and batch: the JAX dry run's tiny PoseNet at 32x32, one momentum step at
1e-3, each rank taking half of the batch.

The port averages the ranks' gradients, as the JAX step's ``pmean`` means
to. Under JAX 0.9's ``shard_map`` the gradient of the replicated
parameters already comes out summed over the axis, and ``pmean`` of that
replicated sum leaves it as it is, so the JAX package's
``make_train_step(axis_name="dp")`` moves the parameters R times as far
as one device's step on the whole batch. So: the loss against the JAX
``shard_map`` step's within 1e-5 relative; the parameters after the update
against the JAX single-device step on the whole batch within 1e-6
(``tests/test_torch_train.py``'s bounds); the JAX ``shard_map`` step's
move pinned at R times the port's; the averaged gradients against the
port's own one-rank step within 1e-5 of each tensor's largest; the
updated parameters bit-identical on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from perception_tpu.models import train as jtrain
from perception_tpu.models.pose import PoseNet as JPoseNet
from perception_tpu.models.pose_data import make_batch
from perception_tpu_torch.convert import posenet_from_flax, train_state_from_jax
from perception_tpu_torch.models import train
from perception_tpu_torch.models.pose import PoseNet
from perception_tpu_torch.parallel.multihost import run_fleet

import torch_fleet_cases

RANKS = 2
NET = dict(num_parts=15, num_limbs=14, num_stages=1, backbone_widths=(4, 4, 4), stage_width=8, stage_depth=1)
HW = (32, 32)
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jnet = JPoseNet(**NET)
    params = jnet.init(jax.random.key(6), jnp.zeros((1,) + HW + (3,)))
    jopt = jtrain.make_optimizer(LR, "momentum")
    jstate = jtrain.init_train_state(params, jopt)
    batch = {k: np.asarray(v) for k, v in make_batch(jax.random.key(7), 2 * RANKS, HW).items() if k != "scene"}

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:RANKS]), ("dp",))
    step = jax.jit(shard_map(jtrain.make_train_step(jnet.apply, jopt, axis_name="dp"), mesh=mesh,
                             in_specs=(P(), P("dp")), out_specs=P()))
    want_state, want_loss = step(jstate, jax.device_put(jax.tree.map(jnp.asarray, batch), NamedSharding(mesh, P("dp"))))

    single_state, _ = jtrain.make_train_step(jnet.apply, jopt)(jstate, jax.tree.map(jnp.asarray, batch))

    opt = train.make_optimizer(LR, "momentum")
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), PoseNet(**NET), opt, device="cpu")
    port_batch = {k: np.ascontiguousarray(np.transpose(v, (0, 3, 1, 2))) for k, v in batch.items()}
    case = dict(net=NET, net_state=state.params.state_dict(), opt_state=state.opt_state.state_dict(),
                step=state.step, lr=LR, kind="momentum", batch=port_batch)
    got = run_fleet(torch_fleet_cases.train_case, RANKS, (case,), device="cpu")
    as_dict = lambda tree: {k: v.numpy() for k, v in
                            posenet_from_flax(jax.tree.map(np.asarray, tree), PoseNet(**NET), "cpu").items()}
    return got, {"shard_map": as_dict(want_state.params), "single": as_dict(single_state.params),
                 "init": as_dict(jstate.params)}, float(want_loss), case


def test_data_parallel_step_matches_jax(setup):
    got, want, want_loss, _ = setup
    assert float(got[0]["loss"]) == pytest.approx(want_loss, rel=1e-5)
    for name, p in got[0]["params"].items():
        np.testing.assert_allclose(p, want["single"][name], rtol=0, atol=1e-6, err_msg=name)
        # The JAX shard_map step moves R times as far (module docstring).
        np.testing.assert_allclose(want["shard_map"][name] - want["init"][name],
                                   RANKS * (p - want["init"][name]), rtol=0, atol=1e-6, err_msg=name)
    assert got[1]["flat"].tobytes() == got[0]["flat"].tobytes()  # both ranks stepped alike


def test_data_parallel_step_matches_one_rank(setup):
    got, _, _, case = setup
    opt = train.make_optimizer(LR, "momentum")
    net = PoseNet(**NET)
    net.load_state_dict(case["net_state"])
    state = train.init_train_state(net, opt)
    state, loss = train.make_train_step(opt)(state, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    assert float(got[0]["loss"]) == pytest.approx(float(loss), rel=1e-5)
    for name, p in net.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(got[0]["grads"][name], g, rtol=0, atol=1e-5 * np.abs(g).max() + 1e-12,
                                   err_msg=name)
