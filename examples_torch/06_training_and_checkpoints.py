"""Example 06 — training a pose net + checkpoint/restore.

The Caffe Solver equivalents (solver.cpp, solvers/*.cpp): the optimizer
zoo with optax's update rules (sgd/nesterov/adam/rmsprop/adagrad/adadelta),
a train step with optional gradient averaging over a process group (the
NCCL-allreduce analog, parallel.cpp:117-340), and snapshot/restore of
the full train state (Solver::Snapshot/Restore, solver.cpp:420-480).
The net's weights and the batch's images are the JAX example's
(``jax.random.key(0)`` and ``key(1)``, drawn by ``utils/jax_random``).
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device  # noqa: E402

import torch  # noqa: E402

from perception_tpu_torch.models.pose import TOPOLOGIES, init_posenet  # noqa: E402
from perception_tpu_torch.models.train import (  # noqa: E402
    init_train_state,
    make_optimizer,
    make_train_step,
    restore,
    snapshot,
)
from perception_tpu_torch.utils import jax_random  # noqa: E402


def main(dev=None) -> dict:
    dev = device(dev)
    topology = "MPI_15"
    net_hw = (32, 32)
    parts, pairs = TOPOLOGIES[topology]

    optimizer = make_optimizer(learning_rate=1e-3, kind="adam")
    step = make_train_step(optimizer)
    state = init_train_state(init_posenet(jax_random.key(0), topology, device=dev), optimizer)

    # Synthetic supervision: random images against fixed target maps
    # (channel-first, as the port's nets take them).
    h8, w8 = net_hw[0] // 8, net_hw[1] // 8
    image = jax_random.uniform(jax_random.key(1), (2, *net_hw, 3))
    heatmap = torch.zeros(2, len(parts) + 1, h8, w8, device=dev)
    heatmap[:, -1] = 1.0
    batch = {
        "image": torch.as_tensor(image, device=dev).permute(0, 3, 1, 2).contiguous(),
        "paf": torch.zeros(2, 2 * len(pairs), h8, w8, device=dev),
        "heatmap": heatmap,
    }

    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    print("loss curve:", " -> ".join(f"{l:.4f}" for l in losses))
    assert losses[-1] < losses[0], "loss should decrease on a fixed batch"

    # Snapshot -> restore into a fresh state (Solver::Snapshot/Restore).
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "solver_iter_5.pt"
        snapshot(path, state)
        fresh = init_train_state(init_posenet(jax_random.key(0), topology, device=dev), optimizer)
        state2 = restore(path, like=fresh)
    same = all(torch.equal(a, b) for a, b in zip(state.params.state_dict().values(),
                                                 state2.params.state_dict().values()))
    print(f"restored step = {int(state2.step)}, params bit-stable = {bool(same)}")
    assert bool(same) and int(state2.step) == 5
    return {"losses": losses, "restored_step": int(state2.step), "bit_stable": bool(same)}


if __name__ == "__main__":
    main()
