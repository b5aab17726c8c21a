"""Held-out robustness of the trained CNN fixtures, with the port.

Counterpart of ``tools/fixtures_robustness.py``: each trained fixture
(``tests/fixtures/*_tiny.msgpack``) is evaluated on generator families the
training run never produced (scale extremes, crowding, pixel noise,
occlusion, background clutter, pose and depth extremes) and the tables of
FIXTURES.md are written. The scenes come from the JAX tool's keys, drawn by
``utils/jax_random`` (each family's ``key(seed)``, split or folded as the
JAX tool does); the noise, clutter and occluders from numpy's
``RandomState(seed)``, as there. So the port's tables are the JAX tool's
numbers for the port's nets and renderers.

Runs on the card unless ``--cpu``. The tables go to ``--out`` (default
``build/FIXTURES.md``; the committed ``FIXTURES.md`` holds the JAX tool's
run and is replaced only when ``--out`` names it) and to the standard
output.

Usage: ``python3 tools_torch/fixtures_robustness.py [--cpu] [--out PATH]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def pose_rows(n_scenes: int = 10, device="cuda"):
    """(family, PCK, recall, overlap) of the tiny MPI-15 PoseNet, where
    overlap is the mean pairwise person-bbox IoU of the family's scenes."""
    import numpy as np
    import torch

    from perception_tpu_torch.models import pose_fixture as PF
    from perception_tpu_torch.models.pose_data import render_people, sample_skeletons_from_key, stack_scenes
    from perception_tpu_torch.utils import jax_random

    params = PF.load_fixture(device)
    hw = PF.FIXTURE_HW

    def family(name, n_people=2, scale=(0.45, 0.75), noise=0.0, occlude=False, clutter=False, seed=0):
        scene_list = [sample_skeletons_from_key(k, hw, n_people=n_people, scale_range=scale)
                      for k in jax_random.split(jax_random.key(seed), n_scenes)]
        scenes = stack_scenes(scene_list)
        imgs = np.stack([render_people(s, hw) for s in scene_list])
        rng = np.random.RandomState(seed)
        if noise > 0.0:
            imgs = np.clip(imgs + rng.randn(*imgs.shape) * noise, 0, 1)
        if clutter:
            yy, xx = np.mgrid[0: hw[0], 0: hw[1]]
            for i in range(n_scenes):
                for _ in range(6):
                    cx, cy = rng.randint(0, hw[1]), rng.randint(0, hw[0])
                    r = rng.randint(6, 18)
                    blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * r * r)))
                    imgs[i] += 0.25 * blob[..., None] * rng.rand(3)
            imgs = np.clip(imgs, 0, 1)
        if occlude:
            for i in range(n_scenes):
                x0 = rng.randint(0, hw[1] - 28)
                y0 = rng.randint(0, hw[0] - 28)
                imgs[i, y0:y0 + 28, x0:x0 + 28] = 0.35
        with torch.no_grad():
            pck, recall = PF.pck_on_images(params, imgs, scenes, device=device)
        ious = []
        for i in range(n_scenes):
            people = [scenes.joints[i][p] for p in range(scenes.joints.shape[1]) if scenes.valid[i][p]]
            for a in range(len(people)):
                for b in range(a + 1, len(people)):
                    lo_a, hi_a = people[a].min(0), people[a].max(0)
                    lo_b, hi_b = people[b].min(0), people[b].max(0)
                    inter = np.prod(np.clip(np.minimum(hi_a, hi_b) - np.maximum(lo_a, lo_b), 0, None))
                    union = np.prod(hi_a - lo_a) + np.prod(hi_b - lo_b) - inter
                    ious.append(inter / max(union, 1e-9))
        return (name, pck, recall, float(np.mean(ious)) if ious else 0.0)

    return [
        family("in-distribution", seed=1),
        family("small figures (scale 0.30-0.45)", scale=(0.30, 0.45), seed=2),
        family("large figures (scale 0.75-0.92)", scale=(0.75, 0.92), seed=3),
        family("crowded (4 people)", n_people=4, seed=4),
        family("pixel noise 0.05", noise=0.05, seed=5),
        family("pixel noise 0.10", noise=0.10, seed=6),
        family("pixel noise 0.20", noise=0.20, seed=7),
        family("occluding 28px box", occlude=True, seed=8),
        family("background clutter", clutter=True, seed=9),
    ]


def face_rows(n_scenes: int = 12, device="cuda"):
    """(family, landmark px error, AU02 separation, detector IoU)."""
    from perception_tpu_torch.models import face_fixture as FF
    from perception_tpu_torch.utils import jax_random

    params = FF.load_fixture(device)

    def family(name, seed=0, **kw):
        return (name, *FF.evaluate(params, jax_random.key(seed), n_scenes=n_scenes, device=device, **kw))

    return [
        family("in-distribution", seed=1),
        family("extreme rotation (0.45 rad)", rot_range=0.45, seed=2),
        family("near faces (z 0.35-0.45)", z_range=(0.35, 0.45), seed=3),
        family("far faces (z 0.75-0.95)", z_range=(0.75, 0.95), seed=4),
        family("pixel noise 0.05", pixel_noise=0.05, seed=5),
        family("pixel noise 0.10", pixel_noise=0.10, seed=6),
    ]


def hand_rows(n_scenes: int = 12, device="cuda"):
    """(family, landmark px error)."""
    from perception_tpu_torch.models import hand_fixture as HF
    from perception_tpu_torch.utils import jax_random

    params = HF.load_fixture(device)

    def family(name, seed=0, **kw):
        return (name, HF.evaluate(params, jax_random.key(seed), n_scenes=n_scenes, device=device, **kw))

    return [
        family("in-distribution", seed=1),
        family("pixel noise 0.05", pixel_noise=0.05, seed=2),
        family("pixel noise 0.10", pixel_noise=0.10, seed=3),
        family("pixel noise 0.20", pixel_noise=0.20, seed=4),
    ]


def tables(pose, face, hand, device) -> list:
    """FIXTURES.md's lines for the rows."""
    lines = [
        "# FIXTURES — held-out robustness of the trained CNN fixtures (the port)",
        "",
        f"Generated by `tools_torch/fixtures_robustness.py` on {device}, from the",
        "JAX tool's keys (`utils/jax_random`); see `tools/fixtures_robustness.py`",
        "for the families and the fixtures' training provenance.",
        "",
        "## Pose (tiny MPI-15 PoseNet, PCK@10px / person recall)",
        "",
        "| family | PCK | recall | overlap |",
        "|---|---|---|---|",
    ]
    lines += [f"| {name} | {pck:.2f} | {rec:.2f} | {ov:.3f} |" for name, pck, rec, ov in pose]
    lines += [
        "",
        "## Face (detector + 70 landmarks + AU02; px err / AU sep / det IoU)",
        "",
        "| family | landmark err (px) | AU02 separation | detector IoU |",
        "|---|---|---|---|",
    ]
    lines += [f"| {name} | {err:.2f} | {sep:+.2f} | {iou:.2f} |" for name, err, sep, iou in face]
    lines += ["", "## Hand (21 landmarks, px err)", "", "| family | landmark err (px) |", "|---|---|"]
    lines += [f"| {name} | {err:.2f} |" for name, err in hand]
    return lines + [""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--out", default=str(ROOT / "build" / "FIXTURES.md"))
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("fixtures_robustness: no CUDA card; pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")
    lines = tables(pose_rows(device=device), face_rows(device=device), hand_rows(device=device), device.type)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines))
    print(f"wrote {out}")
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
