"""Train the tiny hand fixture on synthetic hand scenes, with the port.

Counterpart of ``tools/train_hand_fixture.py``: the same flags and
defaults, the same loss (heatmap MSE x 100), Adam on optax's cosine
schedule (down to 5%). The net starts from ``hand_fixture.init_tiny``
(``torch.Generator`` seed 0), the batches come from
``hand_data.make_hand_batch`` on the run's device (numpy draws, seed 1)
and each evaluation from ``hand_fixture.evaluate`` on the first 12 scenes
of numpy's ``default_rng(99)``. The best net so far is written with
``hand_fixture.save_fixture`` to ``--out``, by default
``build/fixtures/handnet_tiny.msgpack`` (the committed fixture is
replaced only when ``--out`` names it). Exit 0 when the best mean
landmark error is at most 4 px.

Runs on the card unless ``--cpu``. From the repository root:
``python3 tools_torch/train_hand_fixture.py [--steps 3000] [--cpu] [--out PATH]``
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / "fixtures" / "handnet_tiny.msgpack"


def hand_loss(net, batch):
    """Heatmap MSE x 100 on the batch's crops."""
    return ((net(batch["crop"]) - batch["heatmaps"]) ** 2).mean() * 100.0


def error_all_landmarks(net, device, n_scenes: int = 12) -> float:
    """``hand_fixture.evaluate``'s mean landmark error (px) on its scenes
    with every landmark counted, whatever its peak score: an untrained
    net's peaks all fall below the decode threshold, so ``evaluate`` gives
    NaN for it."""
    import numpy as np
    import torch

    from perception_tpu_torch.models.hand_data import hand_box
    from perception_tpu_torch.models.hand_fixture import extract_hand_tiny, sample_scenes

    errs = []
    for scene, img in sample_scenes(np.random.default_rng(99), n_scenes):
        box = torch.from_numpy(hand_box(scene.joints)).to(device)
        uv, _, _ = extract_hand_tiny(net, torch.from_numpy(img).to(device), box)
        errs.append(np.linalg.norm(uv.cpu().numpy() - scene.joints, axis=-1).mean())
    return float(np.mean(errs))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--target-px", type=float, default=1.5)
    ap.add_argument("--pixel-noise", type=float, default=0.25,
                    help="max per-scene Gaussian noise level (fraction of 255): robustness augmentation")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap.parse_args(argv)


def train(args, log=print) -> dict:
    """The training run; returns {"untrained_px" (``error_all_landmarks``
    before the first step), "evals": [(step, loss, px)], "best_px",
    "s_per_step", "device", "net" (the last)}. ``s_per_step`` is the host clock over the
    steps alone (batches included, evaluations excluded), synchronised
    after each step."""
    import numpy as np
    import torch

    from perception_tpu_torch.models.hand_data import make_hand_batch
    from perception_tpu_torch.models.hand_fixture import evaluate, init_tiny, save_fixture
    from perception_tpu_torch.models.train import (
        cosine_decay_schedule,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --cpu to train on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    log(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    net = init_tiny(torch.Generator().manual_seed(0), device)
    log(f"params: {sum(p.numel() for p in net.parameters()) / 1e3:.1f}k")
    untrained = error_all_landmarks(net.eval(), device)
    log(f"untrained: lm_err={untrained:.2f}px (every landmark counted)")

    optimizer = make_optimizer(cosine_decay_schedule(args.lr, args.steps, alpha=0.05), "adam")
    state = init_train_state(net, optimizer)
    step_fn = make_train_step(optimizer, hand_loss)
    rng = np.random.default_rng(1)
    best, evals, train_s = float("inf"), [], 0.0
    t0 = time.time()
    for step in range(1, args.steps + 1):
        t = time.perf_counter()
        batch = make_hand_batch(rng, args.batch, pixel_noise=args.pixel_noise, device=device)
        state, loss = step_fn(state, batch)
        sync()
        train_s += time.perf_counter() - t
        if step % args.eval_every == 0 or step == args.steps:
            err = evaluate(net.eval(), np.random.default_rng(99), device=device)
            net.train()
            evals.append((step, float(loss), err))
            log(f"step {step}: loss={float(loss):.5f} lm_err={err:.2f}px ({time.time() - t0:.0f}s)")
            if err <= best:
                best = err
                save_fixture(net, args.out)
            if err <= args.target_px:
                log("target reached")
                break
    log(f"best lm err {best:.2f}px; fixture at {args.out}")
    return {"untrained_px": untrained, "evals": evals, "best_px": best, "s_per_step": train_s / max(state.step, 1),
            "device": str(device), "net": net}


def main(argv=None) -> int:
    result = train(parse_args(argv), log=lambda s: print(s, flush=True))
    return 0 if result["best_px"] <= 4.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
