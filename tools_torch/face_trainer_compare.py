"""The face fixture trainer of both packages in lockstep, on the CPU.

Both sides start from the same weights: the JAX package's
``face_fixture.init_tiny`` at ``jax.random.key(--key)`` (0 is
``tools/train_face_fixture.py``'s own) or, with ``--init port``, the
port's at ``torch.Generator().manual_seed(--key)`` (0 is
``tools_torch/train_face_fixture.py --numpy-rng``'s own), carried across by
``convert``. Each step takes one
batch key, split from ``jax.random.key(1)`` as the JAX tool splits it:

- the JAX side makes ``make_face_batch(key)`` and takes the JAX tool's
  loss (copied here: the tool defines it inside ``main``) and Adam on
  ``optax.cosine_decay_schedule(lr, steps, alpha=0.05)``;
- the port makes ``make_face_batch(draws=...)`` from the scenes, noise
  and jitter that the same key draws, and takes
  ``tools_torch/train_face_fixture.face_loss`` through
  ``make_train_step`` with ``make_optimizer`` and ``cosine_decay_schedule``
  of the same values.

Every ``--log-every`` steps it prints both losses and their relative
difference. At the end each trained set of nets is evaluated by the
port's ``face_fixture.evaluate`` on the same held-out scenes (the port
tool's: JAX keys 99, and 98 at 0.45 rad, replayed by ``utils.jax_random``), and the
JAX nets also by the JAX package's ``evaluate`` (the JAX tool's keys 99
and 98). ``--ulp-baseline`` puts the JAX tool itself in the port's place,
from the same weights moved up by one ulp: how far rounding alone carries
two runs of one package apart over the same steps. The learning rate and
the augmentation are the trainers' defaults. A JSON summary goes to
``--json`` when given. The two runs part as rounding grows through the
steps, so the tool gates nothing; ``tests/test_torch_train.py`` holds
their first steps together.

From the repository root (``build/`` is ignored by git):
``python3 tools_torch/face_trainer_compare.py [--steps 500] [--init jax|port] [--key 0] [--json build/face_compare.json]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--init", choices=("jax", "port"), default="jax",
                    help="start both sides from the JAX init_tiny at jax.random.key(--key), or from the port's "
                         "init_tiny at torch.Generator().manual_seed(--key)")
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ulp-baseline", action="store_true",
                    help="race the JAX tool against itself from the weights moved up by one ulp, in the port's place")
    ap.add_argument("--no-eval", action="store_true", help="skip the final evaluations")
    ap.add_argument("--json", default=None)
    return ap.parse_args(argv)


def port_nets(params):
    """The port's fixture nets (CPU) holding a JAX fixture tree's weights."""
    import torch

    from perception_tpu_torch.convert import au_head_from_flax, face_detector_from_flax, facenet_from_flax
    from perception_tpu_torch.models.face_fixture import init_tiny

    nets = init_tiny(torch.Generator().manual_seed(0), "cpu")
    for key, convert in (("landmark", facenet_from_flax), ("au", au_head_from_flax), ("det", face_detector_from_flax)):
        nets[key].load_state_dict(convert(params[key], nets[key], "cpu"))
    return nets


def run(args, log=print) -> dict:
    """The lockstep run (JAX on the CPU); returns the losses logged, their
    largest relative difference and the evaluations."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from perception_tpu.models import face_data as jfd
    from perception_tpu.models import face_fixture as jff
    from perception_tpu.models.face import normalize_landmarks as jnorm
    from perception_tpu_torch.convert import au_head_to_flax, face_detector_to_flax, facenet_to_flax
    from perception_tpu_torch.models import face_data, face_fixture
    from perception_tpu_torch.utils import jax_random
    from perception_tpu_torch.models.train import (
        cosine_decay_schedule,
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from train_face_fixture import face_loss
    from train_face_fixture import parse_args as trainer_args

    hw, fx, b = jff.FIXTURE_HW, 300.0, args.batch
    trainer = trainer_args([])  # the learning rate and augmentation of both tools' defaults
    lr, rot, noise_max = trainer.lr, trainer.rot_range, trainer.pixel_noise

    # --- the JAX tool's step, on a batch made from a key -------------------
    lm_net, au_net, det_net = jff.tiny_facenet(), jff.tiny_au_head(), jff.tiny_detector()

    def jax_loss(p, batch):
        maps = lm_net.apply(p["landmark"], batch["crop"])
        lm_loss = jnp.mean((maps - batch["heatmaps"]) ** 2) * 100.0

        def au_one(uv, au_t):
            inten, _ = au_net.apply(p["au"], jnorm(uv, jnp.ones(uv.shape[0], bool)))
            return jnp.mean((inten - au_t) ** 2)

        au_loss = jnp.mean(jax.vmap(au_one)(batch["uv_crop"], batch["au"]))
        heat, size = jax.vmap(lambda im: det_net.apply(p["det"], im[..., None] / 255.0))(batch["image"])
        det_loss = jnp.mean((heat - batch["det_heat"]) ** 2) * 20.0
        wsum = jnp.maximum(jnp.sum(batch["det_weight"]), 1.0)
        size_loss = jnp.sum(batch["det_weight"] * (size - batch["det_size"]) ** 2) / wsum
        return lm_loss + 0.1 * au_loss + det_loss + 0.2 * size_loss

    jopt = optax.adam(optax.cosine_decay_schedule(lr, args.steps, alpha=0.05))

    @jax.jit
    def jax_step(p, o, k):
        batch = {n: v for n, v in jfd.make_face_batch(k, b, rot_range=rot, pixel_noise=noise_max).items()
                 if n != "scene"}
        loss, grads = jax.value_and_grad(jax_loss)(p, batch)
        updates, o = jopt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    # --- the same key's draws, as make_face_batch takes them ---------------
    @jax.jit
    def jax_draws(key):
        def one(k):
            k1, k2, k3 = jax.random.split(k, 3)
            scene = jfd.sample_face(k1, hw, fx, fx, rot_range=rot)
            nk = jax.random.fold_in(k2, 7)
            return (scene, jax.random.normal(k2, hw), jax.random.uniform(k3, (3,), minval=-1.0, maxval=1.0),
                    jax.random.uniform(nk, ()), jax.random.normal(jax.random.fold_in(nk, 1), hw))

        return jax.vmap(one)(jax.random.split(key, b))

    def port_draws(key):
        scene, noise, jitter, level, pixel = jax.tree.map(np.asarray, jax_draws(key))
        scene = face_data.FaceScene(*(np.asarray(getattr(scene, f), np.float32) for f in face_data.FaceScene._fields))
        extra = (level, pixel) if noise_max > 0.0 else (None, None)
        return face_data.FaceDraws(scene, noise, jitter, *extra)

    if args.init == "jax":
        params = jff.init_tiny(jax.random.key(args.key))
    else:
        start = face_fixture.init_tiny(torch.Generator().manual_seed(args.key), "cpu")
        params = jax.tree.map(jnp.asarray, {"landmark": facenet_to_flax(start["landmark"]),
                                            "au": au_head_to_flax(start["au"]),
                                            "det": face_detector_to_flax(start["det"])})
    nets = port_nets(jax.tree.map(np.asarray, params))
    popt = make_optimizer(cosine_decay_schedule(lr, args.steps, alpha=0.05), "adam")
    state = init_train_state(nets, popt)
    pstep = make_train_step(popt, face_loss)
    jstate = jopt.init(params)
    if args.ulp_baseline:
        params2 = jax.tree.map(lambda x: jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf))), params)
        jstate2 = jopt.init(params2)
    other = "JAX+1ulp" if args.ulp_baseline else "port"

    key = jax.random.key(1)
    rows, worst, t0 = [], 0.0, time.time()
    for step in range(1, args.steps + 1):
        key, bk = jax.random.split(key)
        params, jstate, jl = jax_step(params, jstate, bk)
        if args.ulp_baseline:
            params2, jstate2, pl = jax_step(params2, jstate2, bk)
        else:
            batch = face_data.make_face_batch(None, b, rot_range=rot, pixel_noise=noise_max, device="cpu",
                                              draws=port_draws(bk))
            state, pl = pstep(state, batch)
        if step <= 3 or step % args.log_every == 0 or step == args.steps:
            jl, pl = float(jl), float(pl)
            rel = abs(pl - jl) / max(abs(jl), 1e-30)
            worst = max(worst, rel)
            rows.append((step, jl, pl, rel))
            log(f"step {step}: loss JAX {jl:.6f} {other} {pl:.6f} (rel {rel:.2e}) ({time.time() - t0:.0f}s)")

    out = {"steps": args.steps, "init": args.init, "key": args.key, "batch": b, "other": other, "losses": rows,
           "max_loss_rel_first3": max(r[3] for r in rows[:3]), "max_loss_rel": worst}
    if not args.no_eval:
        if args.ulp_baseline:
            nets = port_nets(jax.tree.map(np.asarray, params2))
        nets.eval()
        jnets = port_nets(jax.tree.map(np.asarray, params))
        for name, n in (("other", nets), ("jax", jnets)):
            err, sep, iou = face_fixture.evaluate(n, jax_random.key(99), device="cpu")
            _, sep_rot, _ = face_fixture.evaluate(n, jax_random.key(98), rot_range=0.45, device="cpu")
            out[f"{name}_nets_port_evaluate"] = {"lm_err_px": err, "au02_sep": sep, "au02_sep_045": sep_rot,
                                                 "det_iou": iou}
        err, sep, iou = jff.evaluate(params, jax.random.key(99))
        _, sep_rot, _ = jff.evaluate(params, jax.random.key(98), rot_range=0.45)
        out["jax_nets_jax_evaluate"] = {"lm_err_px": float(err), "au02_sep": float(sep),
                                        "au02_sep_045": float(sep_rot), "det_iou": float(iou)}
        for k in ("other_nets_port_evaluate", "jax_nets_port_evaluate", "jax_nets_jax_evaluate"):
            log(f"{k}: " + ", ".join(f"{n} {v:.4f}" for n, v in out[k].items()))
    out["seconds"] = time.time() - t0
    return out


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    args = parse_args(argv)
    out = run(args, log=lambda s: print(s, flush=True))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
