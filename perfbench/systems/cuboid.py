"""The cuboid detector under a replay of recorded tabletop frames.

The program's entry is ``models/cuboid.cuboid_pipeline_batch``. Set-up
renders the traffic's pool of frames on the device from the seed, draws
each frame's RANSAC triplets from the seed, cuts the pool into batches
by seeded permutations, prepares the template with the program's
``template_features`` and warms the batch shape up. The window is one
closed-loop caller: a batch in, its ``CuboidResult`` read to the host,
the next batch in.
"""

from __future__ import annotations


import numpy as np
import torch

from perfbench.reference import cuboid as reference
from perfbench.reference.common import Precision
from perfbench.scenes import tabletop
from perfbench.systems.record import Window, now

FIELDS = ("pose", "fitness", "accepted", "plane", "plane_valid", "bbox", "num_box_points")


def settings(config: dict) -> dict:
    """The configuration's settings with JSON lists made tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["settings"].items()}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.results = []   # per call: (batch index, {field: numpy array})

    def kernel_shapes(self) -> dict:
        s = self.config["settings"]
        return {"k1": (self.traffic["batch"], s["work_capacity"], s["ransac_hypotheses"])}

    def setup(self):
        from perception_tpu_torch.geometry.camera import PinholeCamera
        from perception_tpu_torch.models.cuboid import (CuboidConfig, cuboid_pipeline_batch,
                                                        template_features)

        cam, tr, dev = self.config["camera"], self.traffic, self.device
        self.entry = cuboid_pipeline_batch
        self.cfg = CuboidConfig(**settings(self.config))
        self.camera = PinholeCamera.from_K([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
                                           width=cam["width"], height=cam["height"])
        self.times = {"program imported": now()}
        self.pool = tabletop.render(cam, tr["scene"], tr["pool"], self.seed, dev)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.indices = torch.randint(0, self.cfg.work_capacity, (tr["pool"], self.cfg.ransac_hypotheses, 3),
                                     generator=g, device=dev)
        gh = torch.Generator().manual_seed(self.seed)
        B = tr["batch"]
        self.batches = []
        for _ in range(tr["orders"]):
            perm = torch.randperm(tr["pool"], generator=gh)
            for a in range(0, tr["pool"] - B + 1, B):
                ids = perm[a:a + B].to(dev)
                self.batches.append((perm[a:a + B].numpy(), self.pool[ids].contiguous(),
                                     self.indices[ids].contiguous()))
        self.times["inputs made"] = now()
        tmpl = tabletop.template_points(self.config["template"]["dims"], self.config["template"]["density"])
        self.template = tmpl
        tpts, tnrm, tmask = template_features(tmpl, np.ones(len(tmpl), bool), self.cfg, device=dev)
        self.tmpl = (tpts, tmask, tnrm)
        self.times["template prepared"] = now()
        for b in range(min(tr["warmup_calls"], len(self.batches))):
            self._host(self._call(b))
        self.times["warmed up"] = now()

    def _call(self, b: int):
        _, depths, idx = self.batches[b]
        tpts, tmask, tnrm = self.tmpl
        return self.entry(depths, self.camera, tpts, tmask, config=self.cfg, template_normals=tnrm,
                          indices=idx)

    @staticmethod
    def _host(res) -> dict:
        return {k: getattr(res, k).cpu().numpy() for k in FIELDS}

    def window(self, seconds: float, rec: Window):
        B, n = self.traffic["batch"], len(self.batches)
        rec.start = now()
        deadline = rec.start + seconds
        j = 0
        while True:
            t0 = now()
            res = self._call(j % n)
            t1 = now()
            out = self._host(res)
            t2 = now()
            self.results.append((j % n, out))
            rec.units += B
            rec.latencies.extend([t2 - t0] * B)
            rec.entry_s += t1 - t0
            rec.spans += [(t0, t1, "in cuboid_pipeline_batch"), (t1, t2, "reading CuboidResult to the host")]
            rec.calls.append((t0, t2, B))
            j += 1
            if t2 >= deadline:
                break
        rec.end = t2

    def release(self):
        """Drop the program's template and entry point; the results are on
        the host and the inputs stay for the reference."""
        self.tmpl = self.entry = None

    def _sample(self):
        """The compared calls, drawn from the seed: (their frames' pool
        rows, the program's answers)."""
        rng = np.random.default_rng(self.seed)
        calls = rng.choice(len(self.results), size=min(self.traffic["check_calls"], len(self.results)),
                           replace=False)
        got = {k: np.concatenate([self.results[c][1][k] for c in calls]) for k in FIELDS}
        return np.concatenate([self.batches[self.results[c][0]][0] for c in calls]), got

    def _reference(self, frames, prec: Precision, ulp: bool = False):
        ids = torch.from_numpy(frames).to(self.device)
        return reference.run(self.pool[ids], self.indices[ids], self.config["camera"], self.config["settings"],
                             self.template, self.config["template"]["dims"], prec, icp_ulp=ulp)

    def check(self, prec: Precision = Precision()):
        """(numbers {name: value}, answers compared)."""
        frames, got = self._sample()
        ref = self._reference(frames, prec)
        numbers, self.detail = compare(got, ref, self.config)
        self.detail["frame"] = int(frames[self.detail["frame"]])
        return numbers, len(frames)

    def ulp_baseline(self):
        """The compared numbers of the reference against itself with every
        box point one float32 ulp away before ICP: how far rounding alone
        moves the answers of the ICP stage."""
        frames, _ = self._sample()
        ref = self._reference(frames, Precision())
        numbers, detail = compare(self._reference(frames, Precision(), ulp=True), ref, self.config)
        return numbers, detail


def corner_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance between two boxes' corner sets (F, 8, 3): the largest
    distance of a corner of one to the nearest corner of the other, so a
    relabelling of the corners (a symmetric pose) reads 0."""
    d = np.linalg.norm(a[:, :, None, :].astype(np.float64) - b[:, None, :, :], axis=-1)
    return np.maximum(d.min(2).max(1), d.min(1).max(1))


def compare(got: dict, ref: dict, config: dict):
    """The compared numbers ({name: value}) and, for the record, the worst
    frame's detail.

    Point-to-plane ICP on a view that is mostly one face holds the box's
    slide along that face weakly, so on about one frame in 500 a restart
    settles millimetres to centimetres away, or another restart wins,
    under rounding alone: the reference against itself with its box points
    one ulp away does the same (PERF.md). So the box and fitness numbers
    are the 90th percentile over the compared frames, not their largest.

    - bbox_gap_p90_m: of each frame's box-corner gap (``corner_gap``);
    - fitness_gap_p90: of each frame's ICP fitness gap over the
      reference's (floor 1e-6);
    - gate_mismatch: frames whose acceptance or plane validity differs
      where the reference's fitness is more than 1% from the gate and its
      point count more than 2 from 50 (a tie under rounding is no fault).
    """
    thr = config["settings"]["fitness_threshold"]
    box_gap = corner_gap(got["bbox"], ref["bbox"])
    fit_gap = np.abs(got["fitness"].astype(np.float64) - ref["fitness"]) / np.maximum(ref["fitness"], 1e-6)
    clear = (np.abs(ref["fitness"] - thr) > 0.01 * thr) & (np.abs(ref["num_box_points"] - 50) > 2)
    differ = (got["accepted"] != ref["accepted"]) | (got["plane_valid"] != ref["plane_valid"])
    numbers = {"bbox_gap_p90_m": float(np.quantile(box_gap, 0.9)),
               "fitness_gap_p90": float(np.quantile(fit_gap, 0.9)),
               "gate_mismatch": float((differ & clear).sum())}
    both = got["plane_valid"] & ref["plane_valid"]
    f = int(np.argmax(box_gap))
    k = ref["restart_fitness"].shape[1]
    detail = {"bbox_gap_max_m": float(box_gap[f]), "fitness_gap_max": float(fit_gap.max()),
              "plane_gap_max": float(np.where(both, np.abs(got["plane"] - ref["plane"]).max(1), 0.0).max()),
              "box_points_gap_max": int(np.abs(got["num_box_points"].astype(np.int64) - ref["num_box_points"]).max()),
              "frame": f, "fitness": float(got["fitness"][f]), "restart_fitness": ref["restart_fitness"][f].tolist(),
              "restart_gap_m": [float(corner_gap(got["bbox"][f:f + 1], ref["restart_bbox"][f:f + 1, r])[0])
                                for r in range(k)]}
    return numbers, detail
