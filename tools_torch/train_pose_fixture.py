"""Train the tiny PoseNet fixture on synthetic skeleton scenes, with the port.

Counterpart of ``tools/train_pose_fixture.py``: the same flags and
defaults, ``models/train.make_train_step`` with ``pose_loss`` under Adam
on optax's cosine schedule (down to 5%). The net starts from
``pose_fixture.init_tiny`` (``torch.Generator`` seed 0), the batches come
from ``pose_data.make_batch`` on the run's device (numpy draws, seed 1);
each evaluation is ``pose_fixture.evaluate_pck`` on numpy's
``default_rng(99)`` and the crowded family (10 scenes of 4 people from
``default_rng(97)``). The best net so far whose crowded recall is at
least 0.8 is written with ``pose_fixture.save_fixture`` to ``--out``, by
default ``build/fixtures/posenet_mpi15_tiny.msgpack`` (the committed
fixture is replaced only when ``--out`` names it). Exit 0 when the best
PCK is at least 0.5.

Runs on the card unless ``--cpu``. From the repository root:
``python3 tools_torch/train_pose_fixture.py [--steps 4000] [--cpu] [--out PATH]``
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "fixtures" / "posenet_mpi15_tiny.msgpack"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--target-pck", type=float, default=0.9)
    ap.add_argument("--n-people", type=int, default=4,
                    help="max people per training scene; 4 covers the crowded held-out family")
    ap.add_argument("--pixel-noise", type=float, default=0.10,
                    help="max per-scene noise level (fraction of scale)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap.parse_args(argv)


def train(args, log=print) -> dict:
    """The training run; returns {"evals": [(step, loss, pck, recall,
    crowd_pck, crowd_recall)], "best_pck", "device"}."""
    import numpy as np
    import torch

    from perception_tpu_torch.models.pose_data import make_batch, render_people, sample_skeletons, stack_scenes
    from perception_tpu_torch.models.pose_fixture import FIXTURE_HW, evaluate_pck, init_tiny, pck_on_images, save_fixture
    from perception_tpu_torch.models.train import (
        cosine_decay_schedule,
        init_train_state,
        make_optimizer,
        make_train_step,
        pose_loss,
    )

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --cpu to train on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    log(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    net = init_tiny(torch.Generator().manual_seed(0), device)
    log(f"params: {sum(p.numel() for p in net.parameters()) / 1e3:.1f}k")

    optimizer = make_optimizer(cosine_decay_schedule(args.lr, args.steps, alpha=0.05), "adam")
    state = init_train_state(net, optimizer)
    step_fn = make_train_step(optimizer, pose_loss)

    def eval_crowded(n=10):
        # The held-out crowded family (4 people), monitored and gated.
        gen = np.random.default_rng(97)
        scenes = [sample_skeletons(gen, FIXTURE_HW, n_people=4) for _ in range(n)]
        images = np.stack([render_people(s, FIXTURE_HW) for s in scenes])
        return pck_on_images(net, images, stack_scenes(scenes), device=device)

    rng = np.random.default_rng(1)
    best_pck, evals = 0.0, []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = make_batch(rng, args.batch, FIXTURE_HW, n_people=args.n_people, pixel_noise=args.pixel_noise,
                           device=device)
        state, loss = step_fn(state, batch)
        if step % args.eval_every == 0 or step == args.steps:
            net.eval()
            pck, recall = evaluate_pck(net, np.random.default_rng(99), device=device)
            cpck, crecall = eval_crowded()
            net.train()
            evals.append((step, float(loss), pck, recall, cpck, crecall))
            log(f"step {step}: loss={float(loss):.5f} pck={pck:.3f} recall={recall:.3f} crowd_pck={cpck:.3f} "
                f"crowd_recall={crecall:.3f} ({time.time() - t0:.0f}s)")
            if pck >= best_pck and crecall >= 0.8:
                best_pck = pck
                save_fixture(net, args.out)
            if pck >= args.target_pck and recall >= 0.95 and crecall >= 0.85:
                log("target reached")
                break
    log(f"best pck {best_pck:.3f}; fixture at {args.out}")
    return {"evals": evals, "best_pck": best_pck, "device": str(device)}


def main(argv=None) -> int:
    result = train(parse_args(argv), log=lambda s: print(s, flush=True))
    return 0 if result["best_pck"] >= 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
