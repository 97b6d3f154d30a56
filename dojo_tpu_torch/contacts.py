"""Sphere–halfspace contacts with the nonlinear (second-order) friction cone.

Counterpart of the halfspace path of dojo_tpu/contacts.py.  Contact block
layout in w (width CW=8): [s(4); γ(4)], s = [s_d, s_ψ, s_t1, s_t2],
γ = [γ_n, γ_ψ, β1, β2]; cones: (s_d, γ_n) positive orthant and
(s[1:4], γ[1:4]) second-order cones.  The other collision pairs and the
impact / linear cone kinds are not ported yet.

Functions take a contact-parameter dict ``cp`` (leading contact axis) and
broadcast over leading batch dimensions of the body configuration.
"""

from __future__ import annotations

import torch

from . import lie
from .joints import mT, mv


def halfspace_distance(cp, x, q):
    """Signed distance of the contact sphere to the halfspace."""
    world = x + lie.rotate(cp["contact_origin"], q) - cp["contact_offset"]
    return torch.sum(cp["contact_normal"] * world, dim=-1) - cp["contact_radius"]


def halfspace_contact_point(cp, x, q):
    """World contact point on the parent body."""
    return (
        x
        + lie.rotate(cp["contact_origin"], q)
        - cp["contact_offset"]
        - cp["contact_normal"] * cp["contact_radius"].unsqueeze(-1)
    )


def contact_point_velocity(x, q, v, w, c):
    """v + ω_world × (c − x)."""
    return v + torch.linalg.cross(lie.rotate(w, q), c - x, dim=-1)


def halfspace_geometry(cp, xp, qp):
    dist = halfspace_distance(cp, xp, qp)
    cpp = halfspace_contact_point(cp, xp, qp)
    return dist, cpp, cp["contact_normal"], cp["contact_tangent"]


def pair_tangential_velocity(tangent, cpp, xp, qp, vp, wp):
    """Tangential velocity of the contact point against the static world."""
    return mv(tangent, contact_point_velocity(xp, qp, vp, wp, cpp))


def pair_constraint_rows(cp, dist, vt, s, gamma):
    """[d − s₀; μγ₀ − γ₁; vt − s₂₃] (nonlinear cone)."""
    mu = cp["contact_friction"]
    return torch.cat(
        [
            torch.stack([dist - s[..., 0], mu * gamma[..., 0] - gamma[..., 1]], dim=-1),
            vt - s[..., 2:4],
        ],
        dim=-1,
    )


def pair_wrench(normal, tangent, cpp, xp3, qp3, gamma):
    """Parent 6-wrench [F_world; τ_body] from contact impulses γ."""
    force = normal * gamma[..., 0:1] + mv(mT(tangent), gamma[..., 2:4])
    tq = lie.rotate_inv(torch.linalg.cross(cpp - xp3, force, dim=-1), qp3)
    return torch.cat([force, tq], dim=-1)


def cone_product(u, v):
    """Second-order cone product [uᵀv; u₀v₁: + v₀u₁:]."""
    return torch.cat(
        [torch.sum(u * v, dim=-1, keepdim=True), u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]],
        dim=-1,
    )


def complementarity(s, gamma):
    """Cone products: orthant pair then the SOC friction cone."""
    soc = cone_product(gamma[..., 1:4], s[..., 1:4])
    return torch.cat([gamma[..., 0:1] * s[..., 0:1], soc], dim=-1)


def neutral_vector(dtype, device=None):
    """Cone-neutral reset point of the nonlinear contact."""
    return torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=dtype, device=device)


def signed_distances(topo, params, state):
    """(..., nc) signed distance per contact at the current configuration."""
    from .residual import contact_params

    idx = torch.as_tensor(topo.contact_parent, dtype=torch.long, device=state.x.device)
    return halfspace_distance(
        contact_params(params), state.x[..., idx, :], state.q[..., idx, :]
    )
