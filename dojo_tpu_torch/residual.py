"""The one-step feasibility residual r(w; z2, θ, μ) and its context.

Counterpart of dojo_tpu/residual.py.  The solver variables w are velocities
and impulses only, so the exact Newton matrix is the forward-mode Jacobian
of this function (blocks.py takes it node by node, the dense rescue takes
it whole).  The residual is defined so that Newton solves J Δ = −r.

Batching: w is (..., dim) and the context fields are (..., nb, k) for any
leading lane dimensions; parameters are shared.  Per-joint and per-contact
terms are evaluated for all joints (contacts) at once with the joint axis
written out where dojo_tpu vmaps, and scattered into the bodies with
one-hot matrices (out-of-place, so torch.func transforms trace through).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import contacts as ct
from . import joints as jk
from . import lie
from .core import BodyState, Params, Topology
from .joints import mv

_JOINT_FIELDS = [
    "tra_cmask", "tra_nmask", "tra_lam_mask", "tra_free_mask",
    "tra_vertex_parent", "tra_vertex_child", "tra_spring", "tra_damper",
    "tra_spring_offset", "tra_lim_lo", "tra_lim_hi", "tra_lim_mask",
    "rot_cmask", "rot_nmask", "rot_lam_mask", "rot_free_mask", "rot_offset",
    "rot_spring", "rot_damper", "rot_spring_offset", "rot_lim_lo",
    "rot_lim_hi", "rot_lim_mask",
]

_CONTACT_FIELDS = [
    "contact_friction", "contact_normal", "contact_tangent",
    "contact_origin", "contact_radius", "contact_offset",
    "contact_child_origin", "contact_child_radius", "contact_aux",
]


def joint_params(params: Params) -> dict:
    return {f: getattr(params, f) for f in _JOINT_FIELDS}


def contact_params(params: Params) -> dict:
    return {f: getattr(params, f) for f in _CONTACT_FIELDS}


@dataclasses.dataclass
class StepContext:
    """Quantities frozen during one solve, each (..., nb, k)."""

    x1: torch.Tensor  # previous position
    q1: torch.Tensor
    x2: torch.Tensor  # current position
    q2: torch.Tensor
    jf2: torch.Tensor  # control force impulses (world frame)
    jt2: torch.Tensor  # control torque impulses (body frame)
    fext: torch.Tensor  # external force (world frame)
    text: torch.Tensor  # external torque (body frame)


def _aug(arr, origin_row):
    """Prepend the origin pseudo-body row (index 0) along the body axis."""
    row = origin_row.expand(*arr.shape[:-2], 1, arr.shape[-1])
    return torch.cat([row, arr], dim=-2)


def _origin(arr, quat=False):
    row = torch.zeros(arr.shape[-1], dtype=arr.dtype, device=arr.device)
    if quat:
        row = row + torch.tensor([1.0, 0, 0, 0], dtype=arr.dtype, device=arr.device)
    return row


def _one_hot(index, n, dtype, device):
    """(n, len(index)) one-hot scatter matrix; index -1 maps to row 0 (the
    origin pseudo-body) when n counts the origin row."""
    m = np.zeros((n, len(index)))
    for k, i in enumerate(index):
        m[i, k] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def _scatter(S, vals):
    """Σ_k S[b, k] vals[..., k, :]: add per-item rows into body rows."""
    return torch.einsum("bk,...kc->...bc", S.to(vals.dtype), vals)


def make_context(topo: Topology, state: BodyState, params: Params, u=None,
                 fext=None, text=None) -> StepContext:
    """Previous configuration from the midpoint velocities, and control
    impulses from the padded inputs u (..., nj, 6) = [u_tra(3), u_rot(3)]."""
    h = params.timestep
    x1 = lie.next_position(state.x, -state.v, h)
    q1 = lie.next_orientation(state.q, -state.w, h)
    jf2 = torch.zeros_like(state.x)
    jt2 = torch.zeros_like(state.x)
    if u is not None:
        jf2, jt2 = input_impulses(topo, state, params, u)
    if fext is None:
        fext = torch.zeros_like(state.x)
    if text is None:
        text = torch.zeros_like(state.x)
    return StepContext(x1, q1, state.x, state.q, jf2, jt2, fext, text)


def input_impulses(topo: Topology, state: BodyState, params: Params, u):
    """Padded per-joint inputs u (..., nj, 6) → per-body (JF2, Jτ2)."""
    h = params.timestep
    nj = topo.nj
    if nj == 0:
        return torch.zeros_like(state.x), torch.zeros_like(state.x)
    dev, dt = state.x.device, state.x.dtype
    pidx = torch.as_tensor(np.asarray(topo.joint_parent) + 1, device=dev)
    cidx = torch.as_tensor(np.asarray(topo.joint_child) + 1, device=dev)
    xa_all = _aug(state.x, _origin(state.x))
    qa_all = _aug(state.q, _origin(state.q, quat=True))
    jp = joint_params(params)
    u = u.reshape(*u.shape[:-2], nj, 6)
    ut3 = mv(jk.mT(jp["tra_nmask"]), u[..., :3])
    ur3 = mv(jk.mT(jp["rot_nmask"]), u[..., 3:])
    (jfa, jta), (jfb, jtb) = jk.input_impulses(
        jp, xa_all[..., pidx, :], qa_all[..., pidx, :],
        xa_all[..., cidx, :], qa_all[..., cidx, :], ut3, ur3, h,
    )
    Sp = _one_hot(np.asarray(topo.joint_parent) + 1, topo.nb + 1, dt, dev)
    Sc = _one_hot(np.asarray(topo.joint_child) + 1, topo.nb + 1, dt, dev)
    jf2 = _scatter(Sp, jfa) + _scatter(Sc, jfb)
    jt2 = _scatter(Sp, jta) + _scatter(Sc, jtb)
    return jf2[..., 1:, :], jt2[..., 1:, :]


def pad_inputs(topo: Topology, u_packed):
    """Packed inputs (..., input_dim) → padded (..., nj, 6) rows (per joint:
    translational free coords, then rotational free coords).

    A gather from the packed vector with a zero appended (index input_dim
    reads the zero), out of place so that torch.func transforms trace it."""
    n = u_packed.shape[-1]
    src = np.full(topo.nj * 6, n, dtype=np.int64)
    k = 0
    for j in range(topo.nj):
        for i in range(topo.tra_nfree[j]):
            src[j * 6 + i], k = k, k + 1
        for i in range(topo.rot_nfree[j]):
            src[j * 6 + 3 + i], k = k, k + 1
    padded = torch.nn.functional.pad(u_packed, (0, 1))
    out = padded[..., torch.as_tensor(src, device=u_packed.device)]
    return out.reshape(*u_packed.shape[:-1], topo.nj, 6)


def _vt(p3):
    """Vᵀ p — embed a 3-vector at positions 1:4 of a quaternion."""
    return torch.cat([torch.zeros_like(p3[..., :1]), p3], dim=-1)


def body_rows(mass, inertia, x1, q1, x2, q2, jf2, jt2, fext, text, v25, w25, g, h):
    """The 6 dynamics rows of each body as a function of its candidate
    velocities (mass (nb,), inertia (nb,3,3), the rest (..., nb, k))."""
    m = mass.unsqueeze(-1)
    x3 = lie.next_position(x2, v25, h)
    q3 = lie.next_orientation(q2, w25, h)
    d1x = -m / h * (x2 - x1) - 0.5 * h * (m * g + fext)
    d2x = m / h * (x3 - x2) - 0.5 * h * (m * g + fext)
    w1 = lie.qmul(lie.qconj(q1), q2)[..., 1:]
    t1 = lie.qmul(lie.qconj(q2), lie.qmul(q1, _vt(mv(inertia, w1))))[..., 1:]
    w2 = lie.qmul(lie.qconj(q2), q3)[..., 1:]
    t2 = lie.qmul(lie.qconj(q2), lie.qconj(lie.qmul(_vt(mv(inertia, w2)), lie.qconj(q3))))[..., 1:]
    dyn_r = -2.0 / h * (t1 + t2) - h * text
    return torch.cat([d1x + d2x - jf2, dyn_r - jt2], dim=-1)


def contact_terms(cp, wc, xp2, qp2, vp, wp, h, mu):
    """Each contact's parent wrench and residual rows (rows evaluated at the
    next configuration).  wc (..., nc, 8); mu broadcasts as (..., 1, 1)."""
    xp3 = lie.next_position(xp2, vp, h)
    qp3 = lie.next_orientation(qp2, wp, h)
    s, gam = wc[..., :4], wc[..., 4:]
    dist, cpp, normal, tangent = ct.halfspace_geometry(cp, xp3, qp3)
    vt = ct.pair_tangential_velocity(tangent, cpp, xp3, qp3, vp, wp)
    wr_p = ct.pair_wrench(normal, tangent, cpp, xp3, qp3, gam)
    neutral = ct.neutral_vector(wc.dtype, wc.device)
    comp_rows = ct.complementarity(s, gam) - mu * neutral
    cons = ct.pair_constraint_rows(cp, dist, vt, s, gam)
    return wr_p, torch.cat([comp_rows, cons], dim=-1)


def joint_terms(jp, eta, xa2, qa2, xb2, qb2, va, wa, vb, wb, h, mu, ML, SW):
    """Each joint's impulse wrenches + residual rows as a function of its
    impulses and the adjacent bodies' candidate velocities."""
    xa3 = lie.next_position(xa2, va, h)
    qa3 = lie.next_orientation(qa2, wa, h)
    xb3 = lie.next_position(xb2, vb, h)
    qb3 = lie.next_orientation(qb2, wb, h)
    eta_t, eta_r = eta[..., :SW], eta[..., SW:]
    st_up, st_lo, gt_up, gt_lo, lam_t = jk.split_subjoint(eta_t, ML)
    sr_up, sr_lo, gr_up, gr_lo, lam_r = jk.split_subjoint(eta_r, ML)

    # ---- impulse wrenches at the current configuration --------------------
    f_tra = jk.subjoint_force(
        jp["tra_cmask"], jp["tra_nmask"], jp["tra_lim_mask"],
        st_up, st_lo, gt_up, gt_lo, lam_t,
    )
    f_rot = jk.subjoint_force(
        jp["rot_cmask"], jp["rot_nmask"], jp["rot_lim_mask"],
        sr_up, sr_lo, gr_up, gr_lo, lam_r,
    )
    tp_t = jk.tra_impulse_transform(jp, "parent", xa2, qa2, xb2, qb2)
    tc_t = jk.tra_impulse_transform(jp, "child", xa2, qa2, xb2, qb2)
    tp_r = jk.rot_impulse_transform(jp, "parent", xa2, qa2, xb2, qb2)
    tc_r = jk.rot_impulse_transform(jp, "child", xa2, qa2, xb2, qb2)
    imp_p = mv(tp_t, f_tra) + mv(tp_r, f_rot)
    imp_c = mv(tc_t, f_tra) + mv(tc_r, f_rot)

    # springs (current config) + dampers (current config, candidate velocities)
    sp_p, sp_c = jk.tra_spring_impulses(jp, xa2, qa2, xb2, qb2, h, tp_t, tc_t)
    sr_p, sr_c = jk.rot_spring_impulses(jp, xa2, qa2, xb2, qb2, h)
    dp_p, dp_c = jk.tra_damper_impulses(
        jp, xa2, va, qa2, wa, xb2, vb, qb2, wb, h, tp_t, tc_t
    )
    dr_p, dr_c = jk.rot_damper_impulses(jp, qa2, wa, qb2, wb, h)
    imp_p = imp_p + sp_p + sr_p + dp_p + dr_p
    imp_c = imp_c + sp_c + sr_c + dp_c + dr_c

    # ---- residual rows at the next configuration --------------------------
    def sub_rows(which):
        if which == "tra":
            e1 = mv(jp["tra_cmask"], jk.tra_displacement(jp, xa3, qa3, xb3, qb3))
            e2 = jk.tra_minimal_coordinates(jp, xa3, qa3, xb3, qb3)
            lmask, lam_mask = jp["tra_lim_mask"], jp["tra_lam_mask"]
            lo, hi = jp["tra_lim_lo"], jp["tra_lim_hi"]
            s_up, s_lo, g_up, g_lo, lam = st_up, st_lo, gt_up, gt_lo, lam_t
        else:
            e1 = mv(jp["rot_cmask"], lie.rotation_vector(jk.rot_displacement_quat(jp, qa3, qb3)))
            e2 = jk.rot_minimal_coordinates(jp, xa3, qa3, xb3, qb3)
            lmask, lam_mask = jp["rot_lim_mask"], jp["rot_lam_mask"]
            lo, hi = jp["rot_lim_lo"], jp["rot_lim_hi"]
            s_up, s_lo, g_up, g_lo, lam = sr_up, sr_lo, gr_up, gr_lo, lam_r
        s2 = torch.cat([s_up, s_lo], dim=-1)
        g2 = torch.cat([g_up, g_lo], dim=-1)
        act2 = torch.cat([lmask, lmask], dim=-1)
        r_comp = act2 * (s2 * g2 - mu) + (1.0 - act2) * (s2 - 1.0)
        e2l = e2[..., :ML]
        r_up = lmask * (s_up - (hi - e2l)) + (1.0 - lmask) * (g_up - 1.0)
        r_lo = lmask * (s_lo - (e2l - lo)) + (1.0 - lmask) * (g_lo - 1.0)
        r_e1 = e1 + (1.0 - lam_mask) * lam
        return torch.cat([r_comp, r_up, r_lo, r_e1], dim=-1)

    rows = torch.cat([sub_rows("tra"), sub_rows("rot")], dim=-1)
    return imp_p, imp_c, rows


class Residual:
    """residual(w, ctx, params, mu) -> r of shape (..., topo.dim).

    Holds the topology's index tensors and one-hot scatter matrices on the
    device; ``mu`` is a scalar or one value per lane (shape w.shape[:-1])."""

    def __init__(self, topo: Topology, device):
        if any(k != "nonlinear" for k in topo.contact_kind) or any(
            g != "halfspace" for g in (topo.contact_geom or ())
        ):
            raise NotImplementedError(
                "only sphere–halfspace contacts with the nonlinear cone are ported"
            )
        self.topo = topo
        dev = torch.device(device)
        self.jparent = torch.as_tensor(np.asarray(topo.joint_parent) + 1, device=dev)
        self.jchild = torch.as_tensor(np.asarray(topo.joint_child) + 1, device=dev)
        self.cparent = torch.as_tensor(np.asarray(topo.contact_parent) + 1, device=dev)
        n = topo.nb + 1
        f64 = torch.float64
        self.Sp = _one_hot(self.jparent.tolist(), n, f64, dev)
        self.Sc = _one_hot(self.jchild.tolist(), n, f64, dev)
        self.Sk = _one_hot(self.cparent.tolist(), n, f64, dev)

    def gather(self, w, ctx: StepContext):
        """Per-body velocities and configurations with the origin row 0."""
        nb = self.topo.nb
        bv = w[..., : 6 * nb].reshape(*w.shape[:-1], nb, 6)
        v25, w25 = bv[..., :3], bv[..., 3:]
        x2a = _aug(ctx.x2, _origin(ctx.x2))
        q2a = _aug(ctx.q2, _origin(ctx.q2, quat=True))
        return bv, _aug(v25, _origin(v25)), _aug(w25, _origin(w25)), x2a, q2a

    def __call__(self, w, ctx: StepContext, params: Params, mu):
        topo = self.topo
        nb, nj, nc, ML = topo.nb, topo.nj, topo.nc, topo.maxlim
        SW, JW, CW = topo.sw, topo.jw, topo.cw
        h = params.timestep
        lead = w.shape[:-1]
        mu = torch.as_tensor(mu, dtype=w.dtype, device=w.device)
        mu = mu.reshape(mu.shape + (1, 1))

        bv, v25a, w25a, x2a, q2a = self.gather(w, ctx)
        r_body = body_rows(
            params.mass, params.inertia, ctx.x1, ctx.q1, ctx.x2, ctx.q2,
            ctx.jf2, ctx.jt2, ctx.fext, ctx.text, bv[..., :3], bv[..., 3:],
            params.gravity, h,
        )
        imp_acc = 0.0
        parts = [r_body]
        if nj:
            jp, jc = self.jparent, self.jchild
            eta = w[..., topo.joint_off : topo.contact_off].reshape(*lead, nj, JW)
            imp_p, imp_c, rows = joint_terms(
                joint_params(params), eta,
                x2a[..., jp, :], q2a[..., jp, :], x2a[..., jc, :], q2a[..., jc, :],
                v25a[..., jp, :], w25a[..., jp, :], v25a[..., jc, :], w25a[..., jc, :],
                h, mu, ML, SW,
            )
            imp_acc = _scatter(self.Sp, imp_p) + _scatter(self.Sc, imp_c)
            parts.append(rows)
        if nc:
            cpi = self.cparent
            wc = w[..., topo.contact_off :].reshape(*lead, nc, CW)
            wr_p, rows = contact_terms(
                contact_params(params), wc,
                x2a[..., cpi, :], q2a[..., cpi, :], v25a[..., cpi, :], w25a[..., cpi, :],
                h, mu,
            )
            imp_acc = imp_acc + _scatter(self.Sk, wr_p)
            parts.append(rows)
        if nj or nc:
            parts[0] = r_body - imp_acc[..., 1:, :]
        return torch.cat([p.reshape(*lead, -1) for p in parts], dim=-1)


def make_residual(topo: Topology, device=None):
    """Returns residual(w, ctx, params, mu) -> r, shaped (..., topo.dim)."""
    from .core import resolve_device

    return Residual(topo, resolve_device(device))
