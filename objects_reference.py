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

Run from the repository root (JAX on the CPU; several minutes, the
clamp's and the plate's ICP over 32 lanes dominate):
``JAX_PLATFORMS=cpu python3 objects_reference.py``
"""

from __future__ import annotations

import time

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


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cam = PinholeCamera.d435_depth()
    poses = standard_clutter_poses()
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
