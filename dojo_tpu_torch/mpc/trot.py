"""Quadruped trot-gait tracking MPC over the runtime-gains iLQR
(counterpart of dojo_tpu/mpc/trot.py, the rt controller).

The gait reference is procedural: diagonal leg pairs (FR+RL / FL+RR) swing
in anti-phase around the standing pose while the base tracks a constant
forward velocity.  The controller is make_ilqr_rt over the IFT-linearized
contact dynamics, with the cost weights, regularization, control clamp and
gait feedforward gain as runtime data (TrotGains).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import SolverOptions
from ..minimal import _joint_slices
from .ilqr import QuadCost, make_ilqr_rt

GROUPS = ("FR", "FL", "RR", "RL")
# diagonal pairs: FR+RL swing together, FL+RR half a period later
PHASE = {"FR": 0.0, "RL": 0.0, "FL": np.pi, "RR": np.pi}


class TrotSpec(NamedTuple):
    """Gait parameters (angles in radians, speeds in m/s)."""

    vx: float = 0.25  # forward base speed
    period: float = 0.6  # gait cycle length [s]
    # trunk height at the gait's standing joint angles (thigh π/4, calf
    # −π/2) with the feet on the floor
    base_height: float = 0.30
    thigh_stand: float = np.pi / 4
    calf_stand: float = -np.pi / 2
    thigh_swing: float = 0.30  # swing-phase thigh lift amplitude
    calf_swing: float = 0.30  # swing-phase calf curl amplitude
    # fore-aft thigh sweep, the propulsion term: the stance foot sweeps
    # from front to back and returns forward during the lifted swing
    sweep: float = 0.25


def _layout(mech):
    """{joint_name: offset} into the minimal vector."""
    slices, _ = _joint_slices(mech.topo)
    return {name: slices[j][0] for name, j in mech.joint_index.items()}


def trot_reference(mech, t0, horizon, dt, spec: TrotSpec = TrotSpec()):
    """(H+1, ny) minimal-coordinate gait reference starting at phase time t0
    (a float or a scalar tensor), in the mechanism's dtype and device."""
    ny = mech.topo.minimal_dim
    offs = _layout(mech)
    t = t0 + dt * torch.arange(horizon + 1, dtype=mech.dtype, device=mech.device)
    phi = 2.0 * np.pi * t / spec.period

    ref = torch.zeros(horizon + 1, ny, dtype=mech.dtype, device=mech.device)
    b = offs["floating_base"]
    ref[:, b + 0] = spec.vx * t  # forward position
    ref[:, b + 2] = spec.base_height
    ref[:, b + 6] = spec.vx  # forward velocity
    for g in GROUPS:
        sw = torch.clamp_min(torch.sin(phi + PHASE[g]), 0.0)  # swing window
        thigh = (spec.thigh_stand - spec.thigh_swing * sw
                 + spec.sweep * torch.cos(phi + PHASE[g]))  # stance propulsion
        ref[:, offs[f"{g}_thigh_joint"]] = thigh
        ref[:, offs[f"{g}_calf_joint"]] = spec.calf_stand - spec.calf_swing * sw
        # hip reference stays 0
    return ref


def trot_cost(mech):
    """Diagonal tracking weights over the quadruped minimal state."""
    ny = mech.topo.minimal_dim
    offs = _layout(mech)
    Q = np.full(ny, 0.0)
    b = offs["floating_base"]
    Q[b + 0 : b + 3] = (8.0, 8.0, 40.0)  # base position
    Q[b + 3 : b + 6] = (20.0, 8.0, 8.0)  # base attitude (roll stiffest)
    Q[b + 6 : b + 9] = (2.0, 1.0, 1.0)  # base velocity
    Q[b + 9 : b + 12] = 0.5  # base angular velocity
    for g in GROUPS:
        for nm, wq, wv in ((f"{g}_hip_joint", 6.0, 0.05), (f"{g}_thigh_joint", 6.0, 0.05),
                           (f"{g}_calf_joint", 4.0, 0.05)):
            o = offs[nm]
            Q[o] = wq
            Q[o + 1] = wv
    R = np.full(12, 2e-3)
    t = lambda a: torch.as_tensor(a, dtype=mech.dtype, device=mech.device)
    return QuadCost(Q=t(Q), R=t(R), Qf=t(2.0 * Q), y_goal=t(np.zeros(ny)))


def actuated_indices(mech):
    """Packed-input indices of the 12 revolute leg joints (the trunk is
    unactuated)."""
    idx = []
    off = 0
    topo = mech.topo
    name_of = {j: n for n, j in mech.joint_index.items()}
    for j in range(topo.nj):
        n_free = topo.tra_nfree[j] + topo.rot_nfree[j]
        if name_of[j] != "floating_base":
            idx.extend(range(off, off + n_free))
        off += n_free
    return np.asarray(idx, dtype=np.int32)


class TrotGains(NamedTuple):
    """Runtime tuning data of the trot controller (the make_ilqr_rt surface)."""

    Qd: torch.Tensor  # (ny,) stage cost diagonal, or (H+1, ny) schedule
    Rd: torch.Tensor  # (nu,)
    Qfd: torch.Tensor  # (ny,) terminal
    reg: torch.Tensor  # Quu Levenberg shift
    du_max: torch.Tensor  # elementwise control-update clamp [N·m]
    # feedforward gait-torque gain [N·m/rad]: u_ff = kff·(q_ref − q_stand)
    # per actuated joint, which biases the warm control sequence toward the
    # swing motion
    kff: torch.Tensor


def trot_gains(mech, pos_x=0.0, vx_w=8.0, joint_w=1.0, reg=10.0, du_max=1e9, r_mul=1.0,
               kff=0.0, dtype=None):
    """Tuned runtime gains: velocity-style base tracking by default (the
    base x-position weight rides to zero)."""
    cost = trot_cost(mech)
    Q = cost.Q.double().cpu().numpy().copy()
    b = _layout(mech)["floating_base"]
    joint_mask = np.ones(len(Q), bool)
    joint_mask[b : b + 12] = False
    Q[b + 0] = pos_x
    Q[b + 6] = vx_w
    Q[joint_mask] *= joint_w
    R = cost.R.double().cpu().numpy() * r_mul
    t = lambda a: torch.as_tensor(a, dtype=dtype or mech.dtype, device=mech.device)
    return TrotGains(Qd=t(Q), Rd=t(R), Qfd=t(2.0 * Q), reg=t(reg), du_max=t(du_max),
                     kff=t(kff))


def _ff_layout(mech, spec: TrotSpec):
    """(cols, stand): per actuated-u index, the minimal position column of
    its joint and the standing angle — the gait feedforward pattern
    u_ff[k, i] = kff·(goals[k, cols[i]] − stand[i])."""
    offs = _layout(mech)
    name_of = {j: n for n, j in mech.joint_index.items()}
    cols, stand = [], []
    for j in range(mech.topo.nj):
        name = name_of[j]
        if name == "floating_base":
            continue
        cols.append(offs[name])
        if name.endswith("_thigh_joint"):
            stand.append(spec.thigh_stand)
        elif name.endswith("_calf_joint"):
            stand.append(spec.calf_stand)
        else:
            stand.append(0.0)  # hips reference 0
    return np.asarray(cols, np.int32), np.asarray(stand, np.float64)


def trot_weight_schedule(mech, t0, horizon, dt, spec: TrotSpec, Qd, swing_scale=1.0,
                         stance_scale=1.0):
    """(H+1, ny) per-knot stage-weight schedule: each leg's thigh/calf
    position weights scale between stance_scale (foot loaded) and
    swing_scale (foot in flight), on the sin(φ) phase of trot_reference."""
    ny = mech.topo.minimal_dim
    offs = _layout(mech)
    Qd = torch.as_tensor(Qd)
    t = t0 + dt * torch.arange(horizon + 1, dtype=Qd.dtype, device=Qd.device)
    phi = 2.0 * np.pi * t / spec.period
    Qs = Qd.expand(horizon + 1, ny).clone()
    for g in GROUPS:
        sw = torch.clamp_min(torch.sin(phi + PHASE[g]), 0.0)  # swing window
        scale = stance_scale + (swing_scale - stance_scale) * sw
        for nm in (f"{g}_thigh_joint", f"{g}_calf_joint"):
            o = offs[nm]
            Qs[:, o] = Qs[:, o] * scale
    return Qs


def trot_spring_params(mech, springs=40.0, dampers=4.0, stand=(-0.001, 0.818, -1.438)):
    """Params with joint springs/dampers on the 12 leg joints and
    gravity-biased spring offsets: the default ``stand`` offsets make the
    standing pose the loaded equilibrium (offset = 2·stand − rest, since
    k(stand − rest) equals the gravity torque at rest)."""
    params = mech.params
    rs = np.zeros(mech.topo.nj)
    rd = np.zeros(mech.topo.nj)
    off = params.rot_spring_offset.double().cpu().numpy().copy()
    hip, thigh, calf = stand
    for name, j in mech.joint_index.items():
        if name == "floating_base":
            continue
        rs[j], rd[j] = springs, dampers
        if name.endswith("_hip_joint"):
            off[j, 0] = hip
        elif name.endswith("_thigh_joint"):
            off[j, 0] = thigh
        elif name.endswith("_calf_joint"):
            off[j, 0] = calf
    t = lambda a: torch.as_tensor(a, dtype=mech.dtype, device=mech.device)
    return dataclasses.replace(params, rot_spring=t(rs), rot_damper=t(rd),
                               rot_spring_offset=t(off))


def make_trot_rt(mech, horizon=40, spec: TrotSpec = TrotSpec(),
                 opts: SolverOptions = SolverOptions(rtol=1e-4, btol=1e-3, max_iter=16),
                 dt=None, alphas=(1.0, 0.5, 0.25, 0.1), iterations=1, linsolve: str = "auto",
                 device=None):
    """Trot controller over the runtime-tunable iLQR (make_ilqr_rt), batched
    over B scenario lanes; ``device=None`` means CUDA.

    Returns (mpc, ref_fn, gains):
      mpc(params, y, dus_warm, goals, Qd, Rd, Qfd, reg, du_max, kff, trace=None)
          → (u0 (B, 12), dus_next (B, H, 12), cost (B,), okf (B,))
        y (B, ny), dus_warm (B, H, 12); goals (H+1, ny) and the gains are
        shared by the lanes.
      ref_fn(t0) → (H+1, ny) gait reference
      gains: TrotGains defaults.
    The carried control sequence is the deviation from the gait feedforward
    u_ff = kff·(q_ref − q_stand); kff=0 gives the plain warm start.  Pair
    with trot_spring_params(mech) for the spring-held stance.
    """
    dt = float(mech.params.timestep) if dt is None else dt
    act = actuated_indices(mech)
    ilqr_rt = make_ilqr_rt(mech.topo, horizon, opts, act_idx=act, alphas=alphas,
                           iterations=iterations, linsolve=linsolve, device=device)
    cols, stand = _ff_layout(mech, spec)

    def mpc(params, y, dus_warm, goals, Qd, Rd, Qfd, reg, du_max, kff, trace=None):
        stand_t = torch.as_tensor(stand, dtype=y.dtype, device=y.device)
        cols_t = torch.as_tensor(cols, dtype=torch.long, device=y.device)
        us_ff = kff * (goals[:horizon, cols_t] - stand_t)
        us, ys, c, okf = ilqr_rt(params, y, dus_warm + us_ff, goals, Qd, Rd, Qfd, reg, du_max,
                                 trace)
        dus = us - us_ff
        dus_next = torch.cat([dus[:, 1:], dus[:, -1:]], dim=1)
        return us[:, 0], dus_next, c, okf

    def ref_fn(t0):
        return trot_reference(mech, t0, horizon, dt, spec)

    return mpc, ref_fn, trot_gains(mech)
