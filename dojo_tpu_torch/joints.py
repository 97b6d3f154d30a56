"""Unified masked joint kernel (counterpart of dojo_tpu/joints.py).

A joint is a translational and a rotational sub-joint, each defined by a
constraint mask (constrained axes) and a nullspace mask (free axes),
zero-padded to 3x3.  Every function takes a joint-parameter dict ``jp``
whose entries carry a leading joint axis and broadcasts over any leading
batch dimensions of the configuration arguments, so the residual calls each
function once for all joints and lanes (where dojo_tpu vmaps it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lie


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., m, n) @ (..., n) -> (..., m)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def mT(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


# ---------------------------------------------------------------------------
# displacements
# ---------------------------------------------------------------------------


def tra_displacement(jp, xa, qa, xb, qb):
    """Anchor-point displacement expressed in the parent frame."""
    d = xb + lie.rotate(jp["tra_vertex_child"], qb) - (
        xa + lie.rotate(jp["tra_vertex_parent"], qa)
    )
    return lie.rotate_inv(d, qa)


def rot_displacement_quat(jp, qa, qb):
    """Relative orientation q = offset⁻¹ ∘ qa⁻¹ ∘ qb."""
    return lie.qmul(lie.qconj(jp["rot_offset"]), lie.qmul(lie.qconj(qa), qb))


def rot_displacement(jp, qa, qb):
    return rot_displacement_quat(jp, qa, qb)[..., 1:]


# ---------------------------------------------------------------------------
# minimal coordinates / velocities
# ---------------------------------------------------------------------------


def tra_minimal_coordinates(jp, xa, qa, xb, qb):
    return mv(jp["tra_nmask"], tra_displacement(jp, xa, qa, xb, qb))


def rot_minimal_coordinates(jp, xa, qa, xb, qb):
    return mv(jp["rot_nmask"], lie.rotation_vector(rot_displacement_quat(jp, qa, qb)))


def tra_minimal_velocities(jp, xa, va, qa, wa, xb, vb, qb, wb, h):
    """Finite-difference minimal velocity."""
    xa1 = lie.next_position(xa, -va, h)
    qa1 = lie.next_orientation(qa, -wa, h)
    xb1 = lie.next_position(xb, -vb, h)
    qb1 = lie.next_orientation(qb, -wb, h)
    dx = mv(jp["tra_nmask"], tra_displacement(jp, xa, qa, xb, qb))
    dx1 = mv(jp["tra_nmask"], tra_displacement(jp, xa1, qa1, xb1, qb1))
    return (dx - dx1) / h


def rot_minimal_velocities(jp, xa, va, qa, wa, xb, vb, qb, wb, h):
    qa1 = lie.next_orientation(qa, -wa, h)
    qb1 = lie.next_orientation(qb, -wb, h)
    q = rot_displacement_quat(jp, qa, qb)
    q1 = lie.qmul(lie.qconj(jp["rot_offset"]), lie.qmul(lie.qconj(qa1), qb1))
    return mv(jp["rot_nmask"], lie.rotation_vector(lie.qmul(lie.qconj(q1), q))) / h


# ---------------------------------------------------------------------------
# impulse transforms: 6x3 maps from constraint-space force to body wrench
# ---------------------------------------------------------------------------


def _transform_from(f, like):
    """AD form of a 6x3 impulse transform from a displacement fn of (dx, φ);
    kept as the test oracle for the closed forms below (one joint)."""
    z3 = like.new_zeros(3)
    jx = torch.func.jacfwd(lambda dx: f(dx, z3))(z3)
    jq = torch.func.jacfwd(lambda p: f(z3, p))(z3)
    return torch.cat([jx.T, 0.5 * jq.T], dim=0)


def tra_impulse_transform_ad(jp, relative, xa, qa, xb, qb):
    if relative == "parent":
        f = lambda dx, p: tra_displacement(jp, xa + dx, lie.quat_perturb(qa, p), xb, qb)
    else:
        f = lambda dx, p: tra_displacement(jp, xa, qa, xb + dx, lie.quat_perturb(qb, p))
    return _transform_from(f, xa)


def rot_impulse_transform_ad(jp, relative, xa, qa, xb, qb):
    if relative == "parent":
        f = lambda dx, p: rot_displacement(jp, lie.quat_perturb(qa, p), qb)
    else:
        f = lambda dx, p: rot_displacement(jp, qa, lie.quat_perturb(qb, p))
    return _transform_from(f, xa)


def tra_impulse_transform(jp, relative, xa, qa, xb, qb):
    """Closed form of Diag(1,½)·[X Q·LVᵀ]ᵀ for the translational sub-joint:
      parent: [−R(qa); −skew(d_a + p_a)]
      child:  [ R(qa);  skew(p_b) R(qb)ᵀ R(qa)]
    """
    Ra = lie.rotation_matrix(qa)
    if relative == "parent":
        d = tra_displacement(jp, xa, qa, xb, qb)
        return torch.cat([-Ra, -lie.skew(d + jp["tra_vertex_parent"])], dim=-2)
    Rb = lie.rotation_matrix(qb)
    return torch.cat([Ra, lie.skew(jp["tra_vertex_child"]) @ mT(Rb) @ Ra], dim=-2)


def rot_impulse_transform(jp, relative, xa, qa, xb, qb):
    """Closed form for the rotational sub-joint: [0; ½·Jφᵀ] with
      parent: Jφ = −V L(off⁻¹) R(qa⁻¹qb) Vᵀ
      child:  Jφ =  V L(off⁻¹ qa⁻¹ qb) Vᵀ
    """
    if relative == "parent":
        s = lie.qmul(lie.qconj(qa), qb)
        m = lie.qmul_jac_right(lie.qconj(jp["rot_offset"]), s)
        jphi = -m[..., 1:, 1:]
    else:
        q_rel = lie.qmul(lie.qconj(jp["rot_offset"]), lie.qmul(lie.qconj(qa), qb))
        jphi = lie.Lmat(q_rel)[..., 1:, 1:]
    return torch.cat([torch.zeros_like(jphi), 0.5 * mT(jphi)], dim=-2)


# ---------------------------------------------------------------------------
# constraint-space forces from the padded impulse block
# ---------------------------------------------------------------------------


def subjoint_force(cmask, nmask, lim_mask, s_up, s_lo, g_up, g_lo, lam):
    """force(3) = cmaskᵀ λ + nmaskᵀ (γ_lo − γ_up) on limited coordinates."""
    ml = g_up.shape[-1]
    dg3 = F.pad(lim_mask * (g_lo - g_up), (0, 3 - ml))
    return mv(mT(cmask), lam) + mv(mT(nmask), dg3)


def split_subjoint(eta, ml):
    """η = [s_up(ML); s_lo(ML); γ_up(ML); γ_lo(ML); λ(3)]."""
    return (
        eta[..., 0:ml],
        eta[..., ml : 2 * ml],
        eta[..., 2 * ml : 3 * ml],
        eta[..., 3 * ml : 4 * ml],
        eta[..., 4 * ml : 4 * ml + 3],
    )


# ---------------------------------------------------------------------------
# springs and dampers
# ---------------------------------------------------------------------------


def _col(s):
    """Per-joint scalar (nj,) as a column that broadcasts over 3-vectors."""
    return s.unsqueeze(-1)


def tra_spring_impulses(jp, xa, qa, xb, qb, h, tp=None, tc=None):
    """Returns (parent 6-impulse, child 6-impulse)."""
    dist = jp["tra_spring_offset"] - tra_minimal_coordinates(jp, xa, qa, xb, qb)
    force = _col(jp["tra_spring"]) * mv(mT(jp["tra_nmask"]), dist)
    if tp is None:
        tp = tra_impulse_transform(jp, "parent", xa, qa, xb, qb)
    if tc is None:
        tc = tra_impulse_transform(jp, "child", xa, qa, xb, qb)
    return h * mv(tp, force), h * mv(tc, force)


def rot_spring_impulses(jp, xa, qa, xb, qb, h):
    dist = jp["rot_spring_offset"] - rot_minimal_coordinates(jp, xa, qa, xb, qb)
    force = -_col(jp["rot_spring"]) * mv(mT(jp["rot_nmask"]), dist)
    fp = lie.rotate(force, jp["rot_offset"])
    q_ba = lie.qmul(lie.qconj(qb), lie.qmul(qa, jp["rot_offset"]))
    fc = lie.rotate(-force, q_ba)
    zero = torch.zeros_like(fp)
    return h * torch.cat([zero, fp], dim=-1), h * torch.cat([zero, fc], dim=-1)


def tra_damper_impulses(jp, xa, va, qa, wa, xb, vb, qb, wb, h, tp=None, tc=None):
    vel = tra_minimal_velocities(jp, xa, va, qa, wa, xb, vb, qb, wb, h)
    force = _col(jp["tra_damper"]) * mv(mT(jp["tra_nmask"]), -vel)
    if tp is None:
        tp = tra_impulse_transform(jp, "parent", xa, qa, xb, qb)
    if tc is None:
        tc = tra_impulse_transform(jp, "child", xa, qa, xb, qb)
    return h * mv(tp, force), h * mv(tc, force)


def rot_damper_impulses(jp, qa, wa, qb, wb, h):
    z = torch.zeros_like(wa)
    vel = rot_minimal_velocities(jp, z, z, qa, wa, z, z, qb, wb, h)
    force = _col(jp["rot_damper"]) * mv(mT(jp["rot_nmask"]), vel)
    fp = lie.rotate(force, jp["rot_offset"])
    q_ba = lie.qmul(lie.qconj(qb), lie.qmul(qa, jp["rot_offset"]))
    fc = lie.rotate(-force, q_ba)
    zero = torch.zeros_like(fp)
    return h * torch.cat([zero, fp], dim=-1), h * torch.cat([zero, fc], dim=-1)


# ---------------------------------------------------------------------------
# control inputs → body impulses
# ---------------------------------------------------------------------------


def input_impulses(jp, xa, qa, xb, qb, u_tra3, u_rot3, h):
    """Per-joint control impulses.  u_*3: force/torque premapped by nmaskᵀ.

    Returns ((JFa, Jτa), (JFb, Jτb)): world-frame force impulses and
    local-frame torque impulses.
    """
    ut = u_tra3 * h
    tp = tra_impulse_transform(jp, "parent", xa, qa, xb, qb)
    tc = tra_impulse_transform(jp, "child", xa, qa, xb, qb)
    jfa, jta = mv(tp[..., :3, :], ut), 0.5 * mv(tp[..., 3:, :], ut)
    jfb, jtb = mv(tc[..., :3, :], ut), 0.5 * mv(tc[..., 3:, :], ut)
    tau = u_rot3 * h
    jta = jta + lie.rotate(-tau, jp["rot_offset"])
    q_ba = lie.qmul(lie.qconj(qb), lie.qmul(qa, jp["rot_offset"]))
    jtb = jtb + lie.rotate(tau, q_ba)
    return (jfa, jta), (jfb, jtb)
