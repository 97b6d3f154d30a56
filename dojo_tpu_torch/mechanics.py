"""Physical diagnostics: discrete momentum and mechanical energy
(counterpart of dojo_tpu/mechanics.py).

The discrete-Legendre momenta are the exactly conserved quantities of the
variational integrator.  Every function is a pure function of (params,
pre-step state, solution w) and broadcasts over any leading lane or time
dimensions of the state (..., nb, k) and the solution (..., dim).
"""

from __future__ import annotations

import numpy as np
import torch

from . import joints as jk
from . import lie
from .core import BodyState, Params, Topology
from .joints import mv
from .residual import (
    StepContext,
    _aug,
    _one_hot,
    _origin,
    _scatter,
    _vt,
    joint_params,
    joint_terms,
)


def _joint_wrench_sum(topo: Topology, params: Params, state: BodyState, w_sol):
    """Per-body sum of the joint wrenches (impulse map·λ + spring + damper)
    at the current configuration and the solution velocities, (..., nb, 6):
    the impulses the residual's body rows take from the joints."""
    nb, nj, lead = topo.nb, topo.nj, w_sol.shape[:-1]
    if nj == 0:
        return state.x.new_zeros(*lead, nb, 6)
    dev, dt = state.x.device, state.x.dtype
    bv = w_sol[..., : 6 * nb].reshape(*lead, nb, 6)
    z3 = _origin(state.x)
    va, wa = _aug(bv[..., :3], z3), _aug(bv[..., 3:], z3)
    xa = _aug(state.x, z3).expand(*lead, nb + 1, 3)
    qa = _aug(state.q, _origin(state.q, quat=True)).expand(*lead, nb + 1, 4)
    p, c = (np.asarray(ix) + 1 for ix in (topo.joint_parent, topo.joint_child))
    eta = w_sol[..., topo.joint_off : topo.contact_off].reshape(*lead, nj, topo.jw)
    imp_p, imp_c, _ = joint_terms(
        joint_params(params), eta, xa[..., p, :], qa[..., p, :], xa[..., c, :], qa[..., c, :],
        va[..., p, :], wa[..., p, :], va[..., c, :], wa[..., c, :], params.timestep, 0.0,
        topo.maxlim, topo.sw,
    )
    acc = (_scatter(_one_hot(p, nb + 1, dt, dev), imp_p)
           + _scatter(_one_hot(c, nb + 1, dt, dev), imp_c))
    return acc[..., 1:, :]


def momentum(topo: Topology, params: Params, state: BodyState, w_sol, ctx: StepContext):
    """Per-body (linear momentum in the world frame, angular momentum in the
    world frame), each (..., nb, 3), after a solve whose solution w_sol
    holds the accepted v25/ω25 and the impulses."""
    nb, h = topo.nb, params.timestep
    bv = w_sol[..., : 6 * nb].reshape(*w_sol.shape[:-1], nb, 6)
    v25, w25 = bv[..., :3], bv[..., 3:]
    x3 = lie.next_position(state.x, v25, h)
    q3 = lie.next_orientation(state.q, w25, h)
    m = params.mass[:, None]
    d2x = m / h * (x3 - state.x) - 0.5 * h * (m * params.gravity + ctx.fext)
    # D2q = −2/h · V L(q2)ᵀ T R(q3)ᵀ Vᵀ (J V L(q2)ᵀ q3) − h/2 τext
    w2 = lie.qmul(lie.qconj(state.q), q3)[..., 1:]
    tq = lie.qconj(lie.qmul(_vt(mv(params.inertia, w2)), lie.qconj(q3)))
    d2q = -2.0 / h * lie.qmul(lie.qconj(state.q), tq)[..., 1:] - 0.5 * h * ctx.text
    f_joint = _joint_wrench_sum(topo, params, state, w_sol)
    p_lin = d2x - 0.5 * ctx.jf2 - 0.5 * f_joint[..., :3]
    p_ang_body = d2q - 0.5 * ctx.jt2 - 0.5 * f_joint[..., 3:]
    return p_lin, lie.rotate(p_ang_body, state.q)


def momentum_consistent_velocities(params: Params, state: BodyState, p_lin, p_ang):
    """The linear velocity (world frame) and angular velocity (body frame)
    of each body from its momenta."""
    vl = p_lin / params.mass[:, None]
    pq_body = lie.rotate_inv(p_ang, state.q)
    return vl, torch.linalg.solve(params.inertia, pq_body[..., None])[..., 0]


def kinetic_energy(params: Params, vl, wl):
    """½ m vlᵀvl + ½ ωlᵀ J ωl summed over bodies, (...,)."""
    ke_lin = 0.5 * (params.mass * (vl * vl).sum(-1)).sum(-1)
    ke_rot = 0.5 * (wl * mv(params.inertia, wl)).sum((-2, -1))
    return ke_lin + ke_rot


def _spring_energy(spring, nmask, dist):
    f = spring[:, None] * mv(jk.mT(nmask), dist)
    return torch.where(spring > 0, 0.5 * (f * f).sum(-1) / spring.clamp_min(1e-30),
                       torch.zeros_like(spring))


def potential_energy(topo: Topology, params: Params, state: BodyState):
    """Gravity and joint-spring potential, (...,)."""
    pe = -(params.mass * (state.x @ params.gravity)).sum(-1)
    if topo.nj == 0:
        return pe
    xa, qa = _aug(state.x, _origin(state.x)), _aug(state.q, _origin(state.q, quat=True))
    p = torch.as_tensor(np.asarray(topo.joint_parent) + 1, device=state.x.device)
    c = torch.as_tensor(np.asarray(topo.joint_child) + 1, device=state.x.device)
    jp = joint_params(params)
    args = (jp, xa[..., p, :], qa[..., p, :], xa[..., c, :], qa[..., c, :])
    pe_t = _spring_energy(jp["tra_spring"], jp["tra_nmask"],
                          jp["tra_spring_offset"] - jk.tra_minimal_coordinates(*args))
    pe_r = _spring_energy(jp["rot_spring"], jp["rot_nmask"],
                          jp["rot_spring_offset"] - jk.rot_minimal_coordinates(*args))
    return pe + (pe_t + pe_r).sum(-1)
