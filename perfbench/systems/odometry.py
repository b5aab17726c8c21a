"""Keyframe odometry under one live camera.

The program's entries are ``models/slam/odometry.init_state`` and
``odometry_step``. Set-up renders one period of the traffic's sweep on
the device from the seed, picks the seed's start frame, bootstraps the
state on it and warms the step up on the frames that follow. The window
hands the stream's frames to ``odometry_step`` one at a time and reads
each step's pose to the host before the next frame, as a robot does.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import odometry as reference
from perfbench.reference.common import Precision, rotation_angle
from perfbench.scenes import room
from perfbench.systems.record import Window, now


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.steps = []   # per step: (state before, frame, diag, pose on the host)

    def kernel_shapes(self) -> dict:
        from perfbench.counts import k2

        s = self.config["settings"]
        return {"k2": (1,) + k2.padded(s["point_budget"], s["keyframe_budget"])}

    def setup(self):
        from perception_tpu_torch.geometry.camera import PinholeCamera
        from perception_tpu_torch.models.slam.odometry import OdometryConfig, init_state, odometry_step

        cam, tr, dev = self.config["camera"], self.traffic, self.device
        self.step_fn = odometry_step
        self.cfg = OdometryConfig(**self.config["settings"])
        self.camera = PinholeCamera.from_K([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
                                           width=cam["width"], height=cam["height"])
        self.times = {"program imported": now()}
        self.frames = room.render(cam, tr["scene"], self.seed, dev)
        self.period = self.frames.shape[0]
        self.start = int(np.random.default_rng(self.seed).integers(self.period))
        self.times["inputs made"] = now()
        self.init = init_state(self.camera, self.frames[self.start], self.cfg)
        self.state = self.init
        self.next = 1
        for _ in range(tr["warmup_steps"]):
            self.state, _ = self._step(self.state, self._frame())
            self.state.pose.cpu()
        self.times["warmed up"] = now()

    def _frame(self) -> int:
        f = (self.start + self.next) % self.period
        self.next += 1
        return f

    def _step(self, state, f: int):
        return self.step_fn(state, self.frames[f], self.camera, self.cfg)

    def window(self, seconds: float, rec: Window):
        rec.start = now()
        deadline = rec.start + seconds
        state = self.state
        while True:
            f = self._frame()
            t0 = now()
            new, diag = self._step(state, f)
            t1 = now()
            pose = new.pose.cpu().numpy()
            t2 = now()
            self.steps.append((state, f, diag, pose))
            state = new
            rec.units += 1
            rec.latencies.append(t2 - t0)
            rec.entry_s += t1 - t0
            rec.spans += [(t0, t1, "in odometry_step"), (t1, t2, "reading the pose to the host")]
            rec.calls.append((t0, t2, 1))
            if t2 >= deadline:
                break
        rec.end = t2
        self.state = state

    def release(self):
        """Drop the entry point; the states the window went through stay,
        since the reference starts each sampled step from one of them."""
        self.step_fn = None

    def check(self, prec: Precision = Precision()):
        """(numbers {name: value}, answers compared).

        The reference takes each sampled step from the program's own state
        before it (pose, keyframe pose and cloud, frame index): the
        trajectory is a product of every earlier step, so a free-running
        reference would part from it by rounding. The bootstrap, which
        this skips, is compared alone: the reference's first keyframe
        against the program's."""
        cfg, cam, tr = self.config["settings"], self.config["camera"], self.traffic
        rng = np.random.default_rng(self.seed)
        promoted = torch.stack([s[2].promoted for s in self.steps]).cpu().numpy()
        promo = np.flatnonzero(promoted)
        pick = set(rng.choice(len(self.steps), size=min(tr["check_steps"], len(self.steps)), replace=False).tolist())
        pick |= set(rng.choice(promo, size=min(tr["check_promotions"], len(promo)), replace=False).tolist())
        rows = []
        init = self.init
        feat = reference.init(self.frames[self.start], cam, cfg)
        rows.append(dict(kf_gap(init, feat), pose_t_gap_m=0.0, pose_r_gap_rad=0.0, promote_mismatch=0.0))
        for i in sorted(pick):
            state, f, _, pose = self.steps[i]
            ref = reference.step(state.pose, state.kf_pose, state.kf_points, state.kf_normals, state.kf_mask,
                                 int(state.frame_index), self.frames[f], cam, cfg, prec)
            row = {
                "pose_t_gap_m": float(np.abs(pose[:3, 3].astype(np.float64) - ref.pose[:3, 3]).max()),
                "pose_r_gap_rad": float(rotation_angle(torch.from_numpy(pose[:3, :3]),
                                                       torch.from_numpy(ref.pose[:3, :3]))),
                "promote_mismatch": float(bool(promoted[i]) != ref.promoted and ref.margin > 1e-3),
                "kf_gap": 0.0, "kf_mask_mismatch": 0.0,
            }
            if promoted[i] and ref.promoted:
                nxt = self.steps[i + 1][0] if i + 1 < len(self.steps) else self.state
                row.update(kf_gap(nxt, ref.features))
            rows.append(row)
        numbers = {k: max(r[k] for r in rows) for k in rows[0]}
        numbers["promote_mismatch"] = sum(r["promote_mismatch"] for r in rows)
        return numbers, len(rows)


def kf_gap(state, feat) -> dict:
    """The keyframe a state holds against the reference's features of the
    same frame: the largest point or normal gap where both masks hold,
    and the number of rows whose masks differ."""
    both = state.kf_mask & feat.kf_mask
    gap = torch.maximum((state.kf_points - feat.kf).abs().amax(-1), (state.kf_normals - feat.kf_normals).abs().amax(-1))
    return {"kf_gap": float(torch.where(both, gap, torch.zeros_like(gap)).max()),
            "kf_mask_mismatch": float((state.kf_mask != feat.kf_mask).sum())}
