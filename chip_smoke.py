"""Smoke run of perception_tpu_torch on one CUDA card.

Builds the fused RANSAC-scoring kernel from ``perception_tpu_torch/csrc``
and checks it against its plain PyTorch version at the main path's
shapes; then drives the port's main path, the cuboid pipeline at
640x480, through ``cuboid_pipeline_from_depth`` (one frame at a time)
and ``cuboid_pipeline_batch`` (B=8) on the 8 bench frames, and checks
acceptance, the pose against ground truth, that every RANSAC call went
through the kernel, and that the card agrees with the port's CPU path.

Prints the card, each check and the times; then a JSON line of the
kernels; and last ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, when there is no card or any check fails.

Run from the repository root: ``python3 chip_smoke.py``
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 8
KERNEL_SHAPES = [  # (B, N, K, all points masked)
    (1, 8192, 1024, False),
    (8, 8192, 1024, False),
    (1, 777, 100, False),
    (1, 8192, 1024, True),
]
TAU = 0.015


def require(ok, message):
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def kernel_inputs(b, n, k, all_masked, device, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, n, 3) * 0.1).astype(np.float32)
    mask = np.zeros((b, n), bool) if all_masked else rng.rand(b, n) > 0.2
    normals = rng.randn(b, k, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    d = (rng.randn(b, k, 1) * 0.05).astype(np.float32)
    hyp = np.concatenate([normals, d], axis=-1)
    return tuple(torch.from_numpy(a).to(device) for a in (pts, mask, hyp))


def cuda_ms(fn, iters):
    """Mean time of ``fn()`` on the card in ms, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel(device):
    """K1 against its plain version at every shape; returns max |diff|."""
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score, ransac_score_reference

    worst = 0
    for b, n, k, all_masked in KERNEL_SHAPES:
        pts, mask, hyp = kernel_inputs(b, n, k, all_masked, device)
        got = ransac_score(pts, mask, hyp, TAU)
        torch.cuda.synchronize()
        want = ransac_score_reference(pts, mask, hyp, TAU)
        diff = int((got - want).abs().max())
        print(f"K1 ransac_score B={b} N={n} K={k} all_masked={all_masked}: "
              f"equal={torch.equal(got, want)} max_abs_err={diff} inliers={int(want.sum())}")
        require(torch.equal(got, want), f"kernel != plain version at {(b, n, k, all_masked)}")
        require(not all_masked or int(got.abs().sum()) == 0, "all-masked counts not zero")
        worst = max(worst, diff)
    return worst


def time_kernel(device):
    """K1 and its plain version at the main path's shapes, in ms."""
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score, ransac_score_reference

    times = {}
    for b in (1, 8):
        pts, mask, hyp = kernel_inputs(b, 8192, 1024, False, device, seed=1)
        # In turns (plain, kernel, kernel, plain); each side keeps its best.
        plain = cuda_ms(lambda: ransac_score_reference(pts, mask, hyp, TAU), 20)
        kern = cuda_ms(lambda: ransac_score(pts, mask, hyp, TAU), 200)
        kern2 = cuda_ms(lambda: ransac_score(pts, mask, hyp, TAU), 200)
        plain2 = cuda_ms(lambda: ransac_score_reference(pts, mask, hyp, TAU), 20)
        times[b] = (min(kern, kern2), min(plain, plain2))
        print(f"time K1 ransac_score (B={b}, N=8192, K=1024): kernel {kern * 1e3:.1f} / "
              f"{kern2 * 1e3:.1f} us, plain {plain * 1e3:.1f} / {plain2 * 1e3:.1f} us")
    return times


def translation_errors(res, gts):
    return np.linalg.norm(res.pose[..., :3, 3].cpu().numpy() - gts[:, :3, 3], axis=-1)


def run_slice(device):
    """Drive the main path on the card and check it; returns its results."""
    from perception_tpu_torch.bench.scene import bench_frames, benchmark_template
    from perception_tpu_torch.geometry.camera import PinholeCamera
    from perception_tpu_torch.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_batch,
        cuboid_pipeline_from_depth,
        decimate,
        ransac_input,
        template_features,
    )
    from perception_tpu_torch.ops.kernels.ransac_score import ransac_score
    from perception_tpu_torch.ops.ransac import _sample_indices

    cfg = CuboidConfig()
    camera = PinholeCamera.d435_depth()
    tnp = benchmark_template()
    depths_np, gts = bench_frames(camera, range(FRAMES))
    depths_cpu = torch.from_numpy(depths_np)
    state = {}
    for dev in ("cpu", device):
        t, tn, tm = template_features(tnp, np.ones(len(tnp), bool), cfg, device=dev)
        state[dev] = dict(template=t, template_mask=tm, template_normals=tn)
    depths = depths_cpu.to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def one(i):
        return cuboid_pipeline_from_depth(depths[i], camera, generator=gen, config=cfg, **state[device])

    def batch():
        return cuboid_pipeline_batch(depths, camera, generator=gen, config=cfg, **state[device])

    # The main path, counted: 8 single-frame calls, then one call at B=8.
    ransac_score.launches = 0
    singles = [one(i) for i in range(FRAMES)]
    batched = batch()
    torch.cuda.synchronize()
    launches = ransac_score.launches
    print(f"main path: {FRAMES} x cuboid_pipeline_from_depth + 1 x cuboid_pipeline_batch(B={FRAMES}): "
          f"K1 launches {launches}")
    require(launches == FRAMES + 1, f"expected {FRAMES + 1} K1 launches (one per RANSAC call)")

    stacked = type(batched)(*(torch.stack(t) for t in zip(*singles)))
    for name, res in (("B=1", stacked), (f"B={FRAMES}", batched)):
        err = translation_errors(res, gts)
        fit = res.fitness.cpu().numpy()
        acc = res.accepted.cpu().numpy()
        print(f"{name}: accepted {acc.tolist()} fitness max {fit.max():.3e} "
              f"translation error mm {np.round(err * 1e3, 2).tolist()}")
        require(acc.all(), f"{name}: not every frame accepted")
        require(np.all(err <= 0.02), f"{name}: translation error over 2 cm")
        require(all(torch.isfinite(t).all() for t in res if t.is_floating_point()),
                f"{name}: non-finite output")
        require(res.pose.shape == (FRAMES, 4, 4) and res.bbox.shape == (FRAMES, 8, 3),
                f"{name}: wrong output shapes")

    # The card against the port's CPU path, with the same RANSAC triplets.
    d, cam2 = decimate(depths_cpu, camera, cfg.depth_stride)
    _, dm = ransac_input(*cam2.backproject_depth(d), cfg)
    idx = _sample_indices(torch.Generator().manual_seed(7), dm, cfg.ransac_hypotheses)
    res = {dev: cuboid_pipeline_batch(depths_cpu.to(dev), camera, config=cfg, indices=idx, **state[dev])
           for dev in ("cpu", device)}
    c, g = res["cpu"], type(res[device])(*(t.cpu() for t in res[device]))
    dt = np.linalg.norm((c.pose[:, :3, 3] - g.pose[:, :3, 3]).numpy(), axis=-1)
    rel = np.abs(g.fitness.numpy() / c.fitness.numpy() - 1)
    print(f"cuda vs cpu (same triplets): accepted equal {torch.equal(c.accepted, g.accepted)}, "
          f"translation diff max {dt.max() * 1e3:.4f} mm, fitness rel diff max {rel.max():.2e}, "
          f"num_box_points cpu {c.num_box_points.tolist()} cuda {g.num_box_points.tolist()}")
    require(torch.equal(c.accepted, g.accepted), "CUDA and CPU accept different frames")
    require(np.all(dt <= 1e-3), "CUDA and CPU poses differ by more than 1 mm")
    require(bool((c.fitness < cfg.fitness_threshold).all() and (g.fitness < cfg.fitness_threshold).all()),
            "fitness over the gate")
    require(np.all(rel <= 5e-2), "CUDA and CPU fitness differ by more than rtol 5e-2")
    return launches, one, batch


def frames_per_s(fn, frames, passes=3):
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(frames / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    from perception_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = build.build("ransac_score")
    build.load_library("ransac_score")
    print(f"build: {lib.relative_to(build.BUILD_DIR.parents[1])} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_name(lib.name + ".log").read_text().strip())

    max_err = check_kernel(device)
    launches, one, batch = run_slice(device)
    times = time_kernel(device)
    fps1, runs1 = frames_per_s(lambda: [one(i) for i in range(FRAMES)], FRAMES)
    fps8, runs8 = frames_per_s(batch, FRAMES)
    print(f"end to end: B=1 {fps1:.2f} frames/s (passes {[round(r, 2) for r in runs1]}), "
          f"B={FRAMES} {fps8:.2f} frames/s (passes {[round(r, 2) for r in runs8]})")

    print(json.dumps({"kernels": [{
        "name": "ransac_score",
        "route": "cuda",
        "source": "perception_tpu_torch/csrc/ransac_score.cu",
        "replaces": "perception_tpu/ops/pallas/ransac_score.py:60",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times[1][0],
        "plain_ms": times[1][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
