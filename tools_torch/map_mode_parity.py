"""Map-mode SLAM on the card against the CPU: where the two part, and by how much.

The configuration is the SLAM bench's map fusion at map_budget 32768 on
the shortlist engine (``bench/slam_bench.bench_config(map_budget=32768,
map_nn="auto")``), over the bench's 300-frame sweep at 640x480.

``lockstep`` (needs a CUDA card): for each frame the CPU's odometry state
is copied to the card and one ``odometry_step`` runs on each device from
that same state, with map mode's choices recorded in order: each shortlist
build's candidate indices, each fast iteration's nearest candidate, each
polish iteration's nearest map point, each Gauss-Newton update's pose.
Prints each frame whose records part (the first record that parts, the
rows whose choice differs, the largest pose difference after it), the
rows whose k-th and (k+1)-th shortlist distances tie exactly, and a
summary line, then times a shortlist build in each form (``time_builds``).
``--parent-form`` first runs the same with the warm start, distances and
poses as they were formed before (4x4 and K=3 matmuls, ``torch.sum`` over
the coordinates, ``torch.topk``'s order among ties, ``nn.nearest_neighbor``
for the polish). ``build-times`` only times the builds, on the map after
``--frames`` frames.

``slam``: ``slam_bench.run`` in map mode on one device; prints one JSON
line (ATE, loop closures, keyframes, BA runs). ``--triplets cpu`` draws the
loop closures' RANSAC triplets from a CPU generator seeded per draw (as
``chip_smoke.py``'s card-against-CPU checks do), so runs on the card and
the CPU differ in rounding alone; ``--triplets device`` keeps the bench's
own generator (``cli bench``'s row). ``--ulp-seed S`` moves the first
frame's depth one ulp up at 64 pixels drawn from numpy's
``default_rng(S)``: the spread of such runs is the rounding baseline
that a card run is compared with. ``--map-decay D`` sets odometry's
``map_decay`` (the decay sweep's rows).

Run from the repository root:
``python3 tools_torch/map_mode_parity.py lockstep [--frames N] [--parent-form]``
``python3 tools_torch/map_mode_parity.py build-times [--frames N]``
``python3 tools_torch/map_mode_parity.py slam [--cpu] [--triplets cpu|device] [--ulp-seed S] [--map-decay D] [--frames N]``
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perception_tpu_torch.bench import slam_bench  # noqa: E402
from perception_tpu_torch.models.slam import odometry as odo  # noqa: E402

ULP_PIXELS = 64
RECORDED = ("_build_shortlist", "_shortlist_nn", "_map_nearest", "_gn_update")
LAST_BUILD = {}  # device type -> the arguments of the last recorded shortlist build
FAR = 1e5  # m: a source row posed this far out is a masked point (apply_mask's sentinel), gated out of GN


def sweep(frames: int, ulp_seed=None):
    """The bench's sweep (camera, gt, grays, depths), the first frame's
    depth moved one ulp up at seeded pixels when ``ulp_seed`` is given."""
    camera, gt, grays, depths = slam_bench.rendered_sequence(300, 640, 480)
    gt, grays, depths = gt[:frames], grays[:frames], depths[:frames].copy()
    if ulp_seed is not None:
        rng = np.random.default_rng(ulp_seed)
        valid = np.flatnonzero(depths[0] > 0)
        at = np.unravel_index(rng.choice(valid, ULP_PIXELS, replace=False), depths[0].shape)
        depths[0][at] = np.nextafter(depths[0][at], np.float32(np.inf))
    return camera, gt, grays, depths


@contextlib.contextmanager
def parent_form():
    """The shortlist path's distances and poses as the parent formed them."""
    from perception_tpu_torch.geometry import se3
    from perception_tpu_torch.ops import nn

    def d2(src_t, map_masked, map_sq, tile=None):
        return torch.sum(src_t * src_t, dim=1)[:, None] - 2.0 * (src_t @ map_masked.T) + map_sq[None, :]

    def candidates(src_t, map_masked, map_sq, k, tile=None):
        vals, idx = torch.topk(d2(src_t, map_masked, map_sq), k, dim=1, largest=False)
        idx, order = torch.sort(idx, dim=1)
        vals, order = torch.sort(torch.gather(vals, 1, order), dim=1, stable=True)
        return torch.gather(idx, 1, order)

    saved = {k: getattr(odo, k) for k in ("_relative", "_posed", "_shortlist_d2", "_shortlist_candidates",
                                          "_sq_norm", "_map_nearest")}
    odo._relative = lambda A, B: se3.inverse(A) @ B
    odo._posed = se3.transform_points
    odo._shortlist_d2 = d2
    odo._shortlist_candidates = candidates
    odo._sq_norm = lambda p: torch.sum(p * p, dim=-1)
    odo._map_nearest = lambda s, m, m_sq: nn.nearest_neighbor(s, m, torch.ones_like(m[:, 0], dtype=torch.bool))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(odo, k, v)


@contextlib.contextmanager
def recording(log, ties):
    """Record the outputs of map mode's choices (on the CPU) in ``log``,
    with the rows of valid source points (a NN choice's first argument is
    the posed source), and in ``ties`` the valid rows of each shortlist
    build whose k-th and (k+1)-th distances are equal. A masked source
    point sits at the sentinel, where many map points tie."""
    saved = {k: getattr(odo, k) for k in RECORDED}

    def wrap(name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            valid = None if name == "_gn_update" else (args[0].abs().amax(dim=1) < FAR).cpu()
            if name == "_build_shortlist":
                LAST_BUILD[args[0].device.type] = args
                src_t, map_masked, map_sq, _, cfg = args
                vals = torch.topk(odo._shortlist_d2(src_t, map_masked, map_sq), cfg.map_nn_shortlist + 1,
                                  dim=1, largest=False)[0].cpu()
                ties.append(int(((vals[:, -1] == vals[:, -2]) & valid).sum()))
            first = out[0] if isinstance(out, tuple) else out
            log.append((name, first.detach().cpu(), valid))
            return out
        return rec

    for k in RECORDED:
        setattr(odo, k, wrap(k, saved[k]))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(odo, k, v)


def to(state, device):
    return type(state)(*(to(x, device) if isinstance(x, tuple) else x.to(device) for x in state))


def lockstep(frames: int, label: str, other: str = "cuda"):
    """The CPU against ``other`` from the CPU's state, frame by frame."""
    camera, _, _, depths = sweep(frames)
    cfg = slam_bench.bench_config(map_budget=32768, map_nn="auto").odometry
    state = odo.init_state(camera, torch.from_numpy(depths[0]), cfg)
    parted, worst_dT, first = [], 0.0, None
    t0 = time.perf_counter()
    for i in range(1, frames):
        logs, ties = {}, {}
        for dev in ("cpu", other):
            logs[dev], ties[dev] = [], []
            with recording(logs[dev], ties[dev]):
                out, _ = odo.odometry_step(state if dev == "cpu" else to(state, torch.device(other)),
                                           torch.from_numpy(depths[i]).to(dev), camera, cfg)
            if dev == "cpu":
                next_state = out
        cpu, card = logs["cpu"], logs[other]
        assert [r[0] for r in cpu] == [r[0] for r in card], "the devices took other paths"
        frame_dT = 0.0
        for j, ((name, a, va), (_, b, vb)) in enumerate(zip(cpu, card)):
            if name == "_gn_update":
                frame_dT = max(frame_dT, float((a - b).abs().max()))
                continue
            differ = (a != b).reshape(a.shape[0], -1).any(dim=1) & (va | vb)
            if differ.any():
                rows = int(differ.sum())
                gn_before = sum(r[0] == "_gn_update" for r in cpu[:j])
                dT = max([float((x[1] - y[1]).abs().max()) for x, y in zip(cpu[:j], card[:j])
                          if x[0] == "_gn_update"], default=0.0)
                parted.append(i)
                first = first or (i, name, gn_before, rows, dT)
                print(f"[{label}] frame {i}: first parts at {name} after {gn_before} GN updates of the frame, "
                      f"{rows} of {int(va.sum())} valid rows differ; largest pose entry difference before it {dT:.3e}; "
                      f"boundary ties cpu {ties['cpu']} card {ties[other]}", flush=True)
                break
        worst_dT = max(worst_dT, frame_dT)
        if any(ties["cpu"]) or any(ties[other]):
            print(f"[{label}] frame {i}: k-th place ties in the shortlist, cpu {ties['cpu']} card {ties[other]}")
        state = next_state
    print(json.dumps({"form": label, "frames": frames, "frames_parted": len(parted),
                      "first": None if first is None else dict(zip(
                          ("frame", "record", "gn_updates_before", "rows", "pose_diff_before"), first)),
                      "largest_pose_entry_diff_after_gn": worst_dT,
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


def _candidates_full_keys(src_t, map_masked, map_sq, k):
    """The shortlist's exact candidates from the whole (Ns, M) matrix and
    one int64-key ``torch.topk`` (the package tiles the same keys)."""
    d2 = odo._shortlist_d2(src_t, map_masked, map_sq)
    m = d2.shape[1]
    return odo._k_smallest(d2, torch.arange(m, device=d2.device), k, m)[0]


def _candidates_tiled_keys(src_t, map_masked, map_sq, k, tile=odo.SHORTLIST_TILE):
    """The same exact candidates a ``tile`` of map columns at a time: each
    tile's int64-key top-k, then the top-k of those (no (Ns, M) matrix)."""
    m = map_masked.shape[0]
    cols, vals = [], []
    for c in range(0, m, tile):
        d2 = odo._shortlist_d2(src_t, map_masked[c:c + tile], map_sq[c:c + tile], tile)
        i, v = odo._nearest_k(d2, min(k, d2.shape[1]))
        cols.append(i + c)
        vals.append(v)
    return odo._k_smallest(torch.cat(vals, 1), torch.cat(cols, 1), k, m)[0]


def time_builds(calls: int = 20) -> dict:
    """ms a shortlist build on the card (CUDA events, ``calls`` calls after
    one) on the last recorded build's inputs, in turns: the parent's form,
    the package's (fixed-order distances; a float top-k of k + 16, the
    exact order among those, a tie pass), and two other exact top-k forms
    (int64 keys over the whole matrix; tile by tile), each held equal to
    the package's; and the distance matrix alone in the parent's and the
    fixed-order form."""
    src_t, map_masked, map_sq, map_points, cfg = LAST_BUILD["cuda"]
    k = cfg.map_nn_shortlist

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls

    def parent(fn):
        def call():
            with parent_form():
                return fn()
        return call

    package = odo._shortlist_candidates(src_t, map_masked, map_sq, k)
    forms = {
        "build_parent": parent(lambda: odo._build_shortlist(src_t, map_masked, map_sq, map_points, cfg)),
        "build_package": lambda: odo._build_shortlist(src_t, map_masked, map_sq, map_points, cfg),
        "candidates_full_keys": lambda: _candidates_full_keys(src_t, map_masked, map_sq, k),
        "candidates_tiled_keys": lambda: _candidates_tiled_keys(src_t, map_masked, map_sq, k),
        "d2_parent": parent(lambda: odo._shortlist_d2(src_t, map_masked, map_sq)),
        "d2_fixed": lambda: odo._shortlist_d2(src_t, map_masked, map_sq),
    }
    equal = {name: bool(torch.equal(forms[name](), package)) for name in ("candidates_full_keys",
                                                                          "candidates_tiled_keys")}
    times = {name: [] for name in forms}
    for name in list(forms) + list(forms)[::-1]:
        times[name].append(round(ms(forms[name]), 4))
    return {"ms": times, "equal_to_package": equal, "shape": [src_t.shape[0], map_masked.shape[0]],
            "device": torch.cuda.get_device_name(0)}


def slam(device: str, frames: int, triplets: str, ulp_seed, map_decay: float = 1.0) -> dict:
    from perception_tpu_torch.models.slam import system
    from perception_tpu_torch.ops.ransac import _sample_indices

    scene = sweep(frames, ulp_seed)
    saved_draw, saved_seq = system._draw_triplets, slam_bench.rendered_sequence
    draws = iter(range(10**6))
    if triplets == "cpu":
        system._draw_triplets = lambda g, m, k: _sample_indices(  # noqa: E731
            torch.Generator().manual_seed(next(draws)), m.cpu(), k).to(m.device)
    slam_bench.rendered_sequence = lambda *a: scene
    try:
        t0 = time.perf_counter()
        out = slam_bench.run(frames=frames, enable_ba=True, map_budget=32768, device=device, map_decay=map_decay)
    finally:
        system._draw_triplets, slam_bench.rendered_sequence = saved_draw, saved_seq
    keys = ("ate_cm", "loop_closures", "keyframes", "ba_runs", "pose_graph_corrections", "device")
    return {"triplets": triplets, "ulp_seed": ulp_seed, "map_decay": map_decay, **{k: out[k] for k in keys},
            "seconds": round(time.perf_counter() - t0, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    lk = sub.add_parser("lockstep")
    lk.add_argument("--frames", type=int, default=300)
    lk.add_argument("--parent-form", action="store_true")
    bt = sub.add_parser("build-times")
    bt.add_argument("--frames", type=int, default=20)
    sl = sub.add_parser("slam")
    sl.add_argument("--cpu", action="store_true")
    sl.add_argument("--frames", type=int, default=300)
    sl.add_argument("--triplets", choices=("cpu", "device"), default="cpu")
    sl.add_argument("--ulp-seed", type=int, default=None)
    sl.add_argument("--map-decay", type=float, default=1.0)
    args = ap.parse_args()
    if args.cmd in ("lockstep", "build-times") and not torch.cuda.is_available():
        raise SystemExit(f"{args.cmd} needs a CUDA card: none is available")
    if args.cmd == "build-times":
        camera, _, _, depths = sweep(args.frames)
        with recording([], []):
            odo.run_odometry(camera, torch.from_numpy(depths).cuda(),
                             slam_bench.bench_config(map_budget=32768, map_nn="auto").odometry)
        print(json.dumps(time_builds()), flush=True)
    elif args.cmd == "lockstep":
        if args.parent_form:
            with parent_form():
                lockstep(args.frames, "parent form")
        lockstep(args.frames, "fixed-order form")
        print(json.dumps(time_builds()), flush=True)
    else:
        device = "cpu" if args.cpu else "cuda"
        if device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA card is available; pass --cpu to run on the CPU")
        print(json.dumps(slam(device, args.frames, args.triplets, args.ulp_seed, args.map_decay)), flush=True)


if __name__ == "__main__":
    main()
