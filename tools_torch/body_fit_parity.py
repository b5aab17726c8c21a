"""The body fit on the card against the CPU, LM iteration by iteration.

``chip_smoke.py``'s 3-D chain fits 8 BODY_25 people with
``models/body_fit.fit_body`` on the card and the CPU and finds their joints
up to 0.13 mm apart. This tool looks for the operation that parts them. It
makes the chain's 8 people (``chip_smoke.chain_people`` on the chain's rig
with its true cameras, 1 px of noise, 5% of the views masked,
``triangulate`` on the CPU), then runs a copy of ``fit_body``'s LM loop on
both devices from the same inputs and records each iteration's residuals
r, Jacobian J, JᵀJ, Jᵀr, step and accept flag. For the loop as it is and
for variants that form JᵀJ and Jᵀr, or the solve, in float64 (one rounding
to float32 after an order-independent sum), it prints one JSON line: per
person the first iteration whose accept flag differs, the joints' largest
difference at the end, and, at the first iteration where anything
differs, which of r, J, JᵀJ, Jᵀr and the step differ there and by how much.

Run from the repository root (needs a CUDA card): ``python3 tools_torch/body_fit_parity.py``
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.func import jacfwd, vmap

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from perception_tpu_torch.geometry import se3  # noqa: E402
from perception_tpu_torch.models import body_fit as bf  # noqa: E402

VARIANTS = {"as is": (False, False), "JtJ and Jtr in float64": (True, False), "solve in float64": (False, True),
            "both in float64": (True, True)}


def chain_inputs():
    """The chain's 8 people triangulated on the CPU: (obs (8, 15, 3), mask (8, 15))."""
    from perception_tpu_torch.ops.triangulate import triangulate

    Ks, T_rig_cam, *_ = chip_smoke.chain_scene()
    rng = np.random.default_rng(chip_smoke.CHAIN_SEED + 2)
    people = chip_smoke.chain_people(rng)
    Pm = (Ks.astype(np.float64) @ np.linalg.inv(T_rig_cam)[:, :3, :]).astype(np.float32)
    X = people.reshape(-1, 3).astype(np.float64)
    proj = np.einsum("cij,nj->nci", Pm.astype(np.float64), np.concatenate([X, np.ones((len(X), 1))], 1))
    uv = (proj[..., :2] / proj[..., 2:] + rng.normal(0, 1.0, proj[..., :2].shape)).astype(np.float32)
    vis = rng.random(uv.shape[:2]) >= 0.05
    res = triangulate(*(torch.from_numpy(a) for a in (Pm, uv, vis)))
    kp = res.points.reshape(chip_smoke.CHAIN_PEOPLE, 25, 3)
    conf = res.valid.reshape(chip_smoke.CHAIN_PEOPLE, 25).to(torch.float32) * 0.9
    sel = torch.from_numpy(bf.BODY15_TO_BODY25.astype(np.int64))
    return kp.index_select(-2, sel), conf.index_select(-1, sel) > 0.05


def fit(obs, obs_mask, f64_normal: bool, f64_solve: bool, iterations=30, huber_delta=0.10, angle_weight=1e-3,
        damping=1e-3):
    """``fit_body``'s loop (fit_scale on), each iteration's arrays recorded."""
    model = bf.BodyModel.body15()
    J = model.parents.shape[0]
    w_mask = obs_mask.to(obs.dtype)
    delta_h = torch.tensor(huber_delta, dtype=obs.dtype).to(obs.device)

    def residuals(theta, observed1, w1):
        twist, angles, log_s = bf._unpack(theta, J)
        joints = bf.forward_kinematics(model, bf._root_T(twist), angles, torch.exp(log_s))
        r = (joints - observed1) * w1[:, None]
        n = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(n > huber_delta, torch.sqrt(delta_h / torch.clamp(n, min=1e-9)), torch.ones_like(n))
        return torch.cat([(r * w[:, None]).reshape(-1), angle_weight * angles.reshape(-1)])

    res_b, jac_b = vmap(residuals), vmap(jacfwd(residuals))
    root0 = torch.where(w_mask[:, :1] > 0, obs[:, 0], torch.zeros_like(obs[:, 0]))
    theta = torch.cat([root0, torch.zeros((obs.shape[0], 3 + 3 * J + 1), dtype=obs.dtype, device=obs.device)], 1)
    lam = torch.full((obs.shape[0],), damping, dtype=obs.dtype, device=obs.device)
    log = []
    for _ in range(iterations):
        r = res_b(theta, obs, w_mask)
        Jac = jac_b(theta, obs, w_mask)
        if f64_normal:
            Jd = Jac.double()
            H = (Jd.transpose(-1, -2) @ Jd).float()
            g = (r.double()[..., None, :] @ Jd)[..., 0, :].float()
        else:
            H = Jac.transpose(-1, -2) @ Jac
            g = (r[..., None, :] @ Jac)[..., 0, :]
        H = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)
        if f64_solve:
            delta = torch.linalg.solve_ex(H.double(), -g.double())[0].float()
        else:
            delta = torch.linalg.solve_ex(H, -g)[0]
        theta_new = theta + delta
        better = torch.sum(res_b(theta_new, obs, w_mask) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        theta = torch.where(better[:, None], theta_new, theta)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 4.0, max=1e3))
        log.append({k: v.cpu() for k, v in (("r", r), ("J", Jac), ("JtJ", H), ("Jtr", g), ("step", delta),
                                            ("better", better))})
    joints = vmap(lambda t: bf.forward_kinematics(model, bf._root_T(bf._unpack(t, J)[0]), bf._unpack(t, J)[1],
                                                  torch.exp(bf._unpack(t, J)[2])))(theta)
    return joints.cpu(), log


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("body_fit_parity compares the card with the CPU: no CUDA card is available")
    obs, mask = chain_inputs()
    for name, (f64_normal, f64_solve) in VARIANTS.items():
        cpu_joints, cpu_log = fit(obs, mask, f64_normal, f64_solve)
        card_joints, card_log = fit(obs.cuda(), mask.cuda(), f64_normal, f64_solve)
        flips = {}
        for p in range(obs.shape[0]):
            it = [i for i, (a, b) in enumerate(zip(cpu_log, card_log)) if bool(a["better"][p] != b["better"][p])]
            if it:
                flips[p] = it[0]
        first = next((i for i, (a, b) in enumerate(zip(cpu_log, card_log))
                      if any(not torch.equal(a[k], b[k]) for k in a)), None)
        at_first = None if first is None else {
            k: float((cpu_log[first][k].float() - card_log[first][k].float()).abs().max()) for k in cpu_log[first]}
        print(json.dumps({
            "variant": name,
            "joints_max_diff_m": float((cpu_joints - card_joints).abs().max()),
            "joints_max_diff_per_person_m": [float(d) for d in (cpu_joints - card_joints).abs().amax(dim=(1, 2))],
            "first_accept_flip_per_person": flips,
            "first_iteration_with_any_difference": first,
            "max_abs_diff_there": at_first,
            "device": torch.cuda.get_device_name(0),
        }), flush=True)


if __name__ == "__main__":
    main()
