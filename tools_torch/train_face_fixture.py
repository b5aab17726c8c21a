"""Train the tiny face fixture (landmark net, AU head, detector) on
synthetic face scenes, with the port.

Counterpart of ``tools/train_face_fixture.py``: the same flags and
defaults and the same loss (``face_loss``), Adam on optax's cosine
schedule (down to 5%), and the JAX tool's key stream, replayed in numpy
by ``utils.jax_random``: the nets start from ``face_fixture.init_tiny(0)``
(the JAX ``init_tiny(jax.random.key(0))``), each step's batch is
``face_data.make_face_batch`` on the run's device from the draws of a key
split off ``jax.random.key(1)`` as the JAX tool splits it, and each
evaluation is ``face_fixture.evaluate`` on ``jax.random.key(99)`` and,
for the held-out tilt family, on ``key(98)`` at 0.45 rad. With
``--numpy-rng`` the nets come from ``torch.Generator`` seed 0 instead, the
batches from numpy's ``default_rng(1)`` and the evaluations from
``default_rng(99)`` and ``(98)``. The best nets so far whose tilted AU02
separation is positive are written with ``face_fixture.save_fixture`` to
``--out``, by default ``build/fixtures/facenet_tiny.msgpack`` (the
committed fixture is replaced only when ``--out`` names it). Exit 0 when
the best mean landmark error is at most 4 px.

Runs on the card unless ``--cpu``. From the repository root:
``python3 tools_torch/train_face_fixture.py [--steps 3000] [--cpu] [--out PATH]``
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "fixtures" / "facenet_tiny.msgpack"


def face_loss(nets, batch):
    """Landmark heatmap MSE x 100 + 0.1 x AU MSE (the AU head on the true
    crop landmarks, as at inference it reads the landmark net's decode,
    normalised the same way) + 20 x detector heat MSE + 0.2 x the
    heat-weighted log-size error."""
    import torch

    from perception_tpu_torch.models.face import normalize_landmarks

    maps = nets["landmark"](batch["crop"])
    lm_loss = ((maps - batch["heatmaps"]) ** 2).mean() * 100.0
    uv = batch["uv_crop"]
    inten, _ = nets["au"](normalize_landmarks(uv, torch.ones(uv.shape[:-1], dtype=torch.bool, device=uv.device)))
    au_loss = ((inten - batch["au"]) ** 2).mean(-1).mean()
    heat, size = nets["det"](batch["image"][:, None] / 255.0)
    det_loss = ((heat - batch["det_heat"]) ** 2).mean() * 20.0
    w = batch["det_weight"]
    size_loss = (w * (size - batch["det_size"]) ** 2).sum() / torch.clamp(w.sum(), min=1.0)
    return lm_loss + 0.1 * au_loss + det_loss + 0.2 * size_loss


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--target-px", type=float, default=2.0)
    ap.add_argument("--rot-range", type=float, default=0.50,
                    help="training head-rotation range (rad); covers the 0.45 rad held-out family")
    ap.add_argument("--pixel-noise", type=float, default=0.12,
                    help="max per-scene noise level (fraction of 255)")
    ap.add_argument("--numpy-rng", action="store_true",
                    help="init from torch.Generator seed 0 and draw batches and evaluations from numpy's "
                         "default_rng(1), (99), (98), not from the JAX tool's keys 0, 1, 99, 98")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap.parse_args(argv)


def train(args, log=print) -> dict:
    """The training run; returns {"evals": [(step, loss, px, au02_sep,
    au02_sep_tilted, det_iou)], "best_px", "device"}."""
    import numpy as np
    import torch

    from perception_tpu_torch.models.face_data import draw_face_batch, draw_face_batch_from_key, make_face_batch
    from perception_tpu_torch.models.face_fixture import evaluate, init_tiny, save_fixture
    from perception_tpu_torch.models.train import (
        cosine_decay_schedule,
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from perception_tpu_torch.utils import jax_random

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --cpu to train on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    log(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    nets = init_tiny(torch.Generator().manual_seed(0) if args.numpy_rng else 0, device)
    log(f"params: {sum(p.numel() for p in nets.parameters()) / 1e3:.1f}k")

    optimizer = make_optimizer(cosine_decay_schedule(args.lr, args.steps, alpha=0.05), "adam")
    state = init_train_state(nets, optimizer)
    step_fn = make_train_step(optimizer, face_loss)
    if args.numpy_rng:
        rng = np.random.default_rng(1)
        held_out = lambda: (np.random.default_rng(99), np.random.default_rng(98))  # fresh each evaluation
    else:
        key = jax_random.key(1)
        held_out = lambda: (jax_random.key(99), jax_random.key(98))
    best, evals = float("inf"), []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        if args.numpy_rng:
            draws = draw_face_batch(rng, args.batch, rot_range=args.rot_range, pixel_noise=args.pixel_noise)
        else:
            key, bk = jax_random.split(key)
            draws = draw_face_batch_from_key(bk, args.batch, rot_range=args.rot_range, pixel_noise=args.pixel_noise)
        batch = make_face_batch(None, args.batch, rot_range=args.rot_range, pixel_noise=args.pixel_noise,
                                device=device, draws=draws)
        state, loss = step_fn(state, batch)
        if step % args.eval_every == 0 or step == args.steps:
            nets.eval()
            held, tilted = held_out()
            err, sep, iou = evaluate(nets, held, device=device)
            _, sep_rot, _ = evaluate(nets, tilted, rot_range=0.45, device=device)
            nets.train()
            evals.append((step, float(loss), err, sep, sep_rot, iou))
            log(f"step {step}: loss={float(loss):.5f} lm_err={err:.2f}px au02_sep={sep:.2f} "
                f"au02_sep@0.45rad={sep_rot:.2f} det_iou={iou:.2f} ({time.time() - t0:.0f}s)")
            if err <= best and sep_rot > 0.0:
                best = err
                save_fixture(nets, args.out)
            if err <= args.target_px and sep > 1.0 and sep_rot > 0.3 and iou > 0.6:
                log("target reached")
                break
    log(f"best lm err {best:.2f}px; fixture at {args.out}")
    return {"evals": evals, "best_px": best, "device": str(device)}


def main(argv=None) -> int:
    result = train(parse_args(argv), log=lambda s: print(s, flush=True))
    return 0 if result["best_px"] <= 4.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
