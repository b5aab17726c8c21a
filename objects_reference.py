"""The JAX package's detection service in ``benchmarks/objects_bench.py``'s
setting, on the CPU: per class, what the service answers and how far its
pose is from the ground truth.

The 640x480 D435 clutter scene at seed 3, ``ObjectConfig(cluster_min_size=40,
size_gate=250)``, the four captured class templates and a 0.3 x 0.3 x
0.02 m plate that matches no object; one call each with
``jax.random.key(0)``. Prints, per template, success, the winning cluster,
the size difference, the cluster sizes and the chamfer error (cm) of the
template under the returned pose against the ground-truth pose, the
measure ``chip_smoke.py`` gates the port's card run with. The reference
for reading the port's objects phase: a class the JAX package also
misses is not a fault of the port.

With ``--cli`` it prints the second table instead: the JAX package's
command line, ``cli objects --depth clutter.png --template CLASS.pcd``
at its defaults (``ObjectConfig()``, ``--seed 0``), on the same scene
stored as a 16-bit PNG in millimetres (``depth * 1000`` cast to uint16)
with each class's template as a binary PCD, the files ``chip_smoke.py``'s
``run_cli`` phase gives the port's command line. The winning cluster is
read from the ``detect_object`` result the command computed.

Run from the repository root (JAX on the CPU; several minutes, the
clamp's and the plate's ICP over 32 lanes dominate):
``JAX_PLATFORMS=cpu python3 objects_reference.py [--cli]``
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from benchmarks.clutter_scene import captured_template, render_depth_clutter, standard_clutter_poses
from perception_tpu.geometry.camera import PinholeCamera
from perception_tpu.io.templates import box_surface_template
from perception_tpu.models.objects import ObjectConfig, detect_object

CLASSES = ("eraser", "screwdriver", "clamp", "marker")


def chamfer_cm(template, est, gt):
    a = template @ est[:3, :3].T + est[:3, 3]
    b = template @ gt[:3, :3].T + gt[:3, 3]
    return float(cKDTree(b).query(a)[0].mean() * 100.0)


def cli_table(cam, poses) -> None:
    """The JAX CLI's ``objects`` answers on the scene's mm PNG, per class."""
    import cv2

    from perception_tpu import cli
    from perception_tpu.io.pcd import write_pcd
    from perception_tpu.models import objects

    seen = []
    real = objects.detect_object

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    with tempfile.TemporaryDirectory() as tmp:
        png = str(Path(tmp) / "clutter.png")
        depth = render_depth_clutter(cam, poses, seed=3)
        cv2.imwrite(png, np.clip(depth * 1000.0, 0, 65535).astype(np.uint16))
        objects.detect_object = spy
        try:
            for name in CLASSES:
                tmpl = captured_template(name, cam)
                pcd = str(Path(tmp) / f"{name}.pcd")
                write_pcd(pcd, tmpl, binary=True)
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    cli.main(["objects", "--depth", png, "--template", pcd, "--cpu"])
                res = json.loads(out.getvalue().splitlines()[-1])
                err = chamfer_cm(tmpl, np.asarray(res["pose"], np.float64), poses[name])
                print(f"[{name}] cli objects: success {res['success']}, cluster {int(seen[-1].cluster_id)}, size "
                      f"diff {res['size_diff']}, clusters {res['num_clusters']} sizes {res['cluster_sizes']}, "
                      f"chamfer {err:.3f} cm ({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
        finally:
            objects.detect_object = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cli", action="store_true", help="the JAX CLI on the scene's mm PNG at its defaults")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    cam = PinholeCamera.d435_depth()
    poses = standard_clutter_poses()
    if args.cli:
        print(f"JAX {jax.__version__} on {jax.devices()[0].platform}")
        return cli_table(cam, poses)
    pts, mask = cam.backproject_depth(jnp.asarray(render_depth_clutter(cam, poses, seed=3)))
    cfg = ObjectConfig(cluster_min_size=40, size_gate=250)
    templates = {name: captured_template(name, cam) for name in CLASSES}
    templates["plate"] = box_surface_template((0.3, 0.3, 0.02), 0.003)
    print(f"JAX {jax.__version__} on {jax.devices()[0].platform}; template points "
          f"{ {name: len(t) for name, t in templates.items()} }")
    for name, tmpl in templates.items():
        t0 = time.perf_counter()
        res = detect_object(pts, mask, jnp.asarray(tmpl), jnp.ones(len(tmpl), bool), jax.random.key(0), cfg)
        jax.block_until_ready(res)
        line = (f"[{name}] success {bool(res.success)}, cluster {int(res.cluster_id)}, size diff "
                f"{int(res.size_diff)}, clusters {int(res.num_clusters)} sizes {np.asarray(res.cluster_sizes).tolist()}")
        if name in poses:
            line += f", chamfer {chamfer_cm(tmpl, np.asarray(res.pose, np.float64), poses[name]):.3f} cm"
        print(f"{line} ({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main()
