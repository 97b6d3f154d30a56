"""Direct per-node KKT block assembly (counterpart of dojo_tpu/blocks.py).

Instead of differentiating the whole residual, each body, joint and contact
differentiates only its own local variables (its impulses plus the adjacent
bodies' velocities) with forward-mode AD of the same per-node functions the
residual evaluates, and the local Jacobians are scattered straight into the
(..., S, W, W) block array of the elimination schedule.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .core import REG, Params, Topology
from .graph import Schedule
from .residual import (
    Residual,
    StepContext,
    body_rows,
    contact_params,
    contact_terms,
    joint_params,
    joint_terms,
)


def local_jacobian(f, u, chunk_size=None):
    """J[..., i, k] = ∂f(u)[..., i] / ∂u[..., k] for an f that maps every
    leading index of u (lane, joint, contact) independently: one jvp per
    local variable, each seeded in all leading indices at once."""
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    basis = eye.reshape((n,) + (1,) * (u.ndim - 1) + (n,)).expand((n,) + tuple(u.shape))
    jt = torch.func.vmap(
        lambda t: torch.func.jvp(f, (u,), (t,))[1], chunk_size=chunk_size
    )(basis)
    return jt.movedim(0, -1)


J_ROLES = ["jj", "jp", "jc", "pj", "pp", "pc", "cj", "cp", "cc"]
C_ROLES = ["kk", "kp", "pk", "pp"]  # halfspace contacts: parent body only


class Assembler:
    """assemble(w, ctx, params, mu) -> (..., S, W, W) block array.

    Blocks that involve the origin pseudo-body (whose velocities are not
    decision variables) land in a trash slot S that is dropped."""

    def __init__(self, topo: Topology, sched: Schedule, device):
        dev = torch.device(device)
        self.topo, self.sched = topo, sched
        self.res = Residual(topo, dev)
        nj, nc = topo.nj, topo.nc
        W, S = sched.width, sched.n_slots
        slot = dict(sched.slot)

        def slot_of(a, b):
            return S if a is None or b is None else slot[(a, b)]

        jp_body = [p if p >= 0 else None for p in topo.joint_parent]
        self.j_slots = {}
        for role in J_ROLES:
            pick = lambda j, r: {
                "j": int(sched.joint_node[j]), "p": jp_body[j], "c": topo.joint_child[j]
            }[r]
            self.j_slots[role] = torch.as_tensor(
                [slot_of(pick(j, role[0]), pick(j, role[1])) for j in range(nj)],
                dtype=torch.long, device=dev,
            )
        # a halfspace contact lives in its parent body's node: all four of
        # its role blocks land in that node's diagonal slot
        diag = torch.as_tensor([slot[(p, p)] for p in topo.contact_parent],
                               dtype=torch.long, device=dev)
        self.c_slots = dict.fromkeys(C_ROLES, diag)
        # one-hot row/col placement of each joint / contact block in its node
        Pj = np.zeros((nj, W, topo.jw))
        for j in range(nj):
            off = int(sched.joint_offset[j])
            Pj[j, off : off + topo.jw] = np.eye(topo.jw)
        Pk = np.zeros((nc, W, topo.cw))
        for c in range(nc):
            off = int(sched.contact_offset[c])
            Pk[c, off : off + topo.cw] = np.eye(topo.cw)
        self.Pj = torch.as_tensor(Pj, device=dev)
        self.Pk = torch.as_tensor(Pk, device=dev)
        self.reg_eye = torch.as_tensor(sched.pad_eye + REG * sched.real_diag, device=dev)

    def _place(self, blocks, JJ, roles, groups, P, slots, lead_dims):
        """Cut the local Jacobian into its (row, col) role blocks, place each
        inside its W×W node block and scatter-add into its slot."""
        W = self.sched.width
        P = P.to(JJ.dtype)
        for role in roles:
            (r0, r1), (c0, c1) = groups[role[0]], groups[role[1]]
            sub = JJ[..., r0:r1, c0:c1]
            if role[0] in "jk":
                sub = P @ sub
            else:
                sub = F.pad(sub, (0, 0, 0, W - sub.shape[-2]))
            if role[1] in "jk":
                sub = sub @ P.transpose(-1, -2)
            else:
                sub = F.pad(sub, (0, W - sub.shape[-1]))
            blocks.index_add_(lead_dims, slots[role], sub)

    def __call__(self, w, ctx: StepContext, params: Params, mu):
        topo, sched = self.topo, self.sched
        nb, nj, nc, ML = topo.nb, topo.nj, topo.nc, topo.maxlim
        SW, JW, CW = topo.sw, topo.jw, topo.cw
        W, S = sched.width, sched.n_slots
        h, g = params.timestep, params.gravity
        lead = w.shape[:-1]
        mu = torch.as_tensor(mu, dtype=w.dtype, device=w.device)
        mu = mu.reshape(mu.shape + (1, 1))
        bv, v25a, w25a, x2a, q2a = self.res.gather(w, ctx)
        blocks = w.new_zeros(*lead, S + 1, W, W)

        # ---- body diagonal: ∂(dyn rows)/∂(v,ω) ------------------------------
        def body_f(u):
            return body_rows(
                params.mass, params.inertia, ctx.x1, ctx.q1, ctx.x2, ctx.q2,
                ctx.jf2, ctx.jt2, ctx.fext, ctx.text, u[..., :3], u[..., 3:], g, h,
            )

        Db = local_jacobian(body_f, bv)
        blocks[..., :nb, :, :] += F.pad(Db, (0, W - 6, 0, W - 6))

        # ---- joints: local variables [η, v_p, ω_p, v_c, ω_c] ----------------
        if nj:
            jp, jc = self.res.jparent, self.res.jchild
            xa2, qa2 = x2a[..., jp, :], q2a[..., jp, :]
            xb2, qb2 = x2a[..., jc, :], q2a[..., jc, :]
            jpar = joint_params(params)
            eta = w[..., topo.joint_off : topo.contact_off].reshape(*lead, nj, JW)

            def joint_f(u):
                imp_p, imp_c, rows = joint_terms(
                    jpar, u[..., :JW], xa2, qa2, xb2, qb2,
                    u[..., JW : JW + 3], u[..., JW + 3 : JW + 6],
                    u[..., JW + 6 : JW + 9], u[..., JW + 9 : JW + 12],
                    h, mu, ML, SW,
                )
                return torch.cat([rows, -imp_p, -imp_c], dim=-1)

            u0 = torch.cat(
                [eta, v25a[..., jp, :], w25a[..., jp, :], v25a[..., jc, :], w25a[..., jc, :]],
                dim=-1,
            )
            groups = {"j": (0, JW), "p": (JW, JW + 6), "c": (JW + 6, JW + 12)}
            self._place(blocks, local_jacobian(joint_f, u0), J_ROLES, groups,
                        self.Pj, self.j_slots, len(lead))

        # ---- contacts: local variables [s, γ, v_p, ω_p] --------------------
        if nc:
            cpi = self.res.cparent
            xp2, qp2 = x2a[..., cpi, :], q2a[..., cpi, :]
            cpar = contact_params(params)
            wc = w[..., topo.contact_off :].reshape(*lead, nc, CW)

            def contact_f(u):
                wr_p, rows = contact_terms(
                    cpar, u[..., :CW], xp2, qp2, u[..., CW : CW + 3],
                    u[..., CW + 3 : CW + 6], h, mu,
                )
                return torch.cat([rows, -wr_p], dim=-1)

            u0 = torch.cat([wc, v25a[..., cpi, :], w25a[..., cpi, :]], dim=-1)
            groups = {"k": (0, CW), "p": (CW, CW + 6)}
            self._place(blocks, local_jacobian(contact_f, u0), C_ROLES, groups,
                        self.Pk, self.c_slots, len(lead))

        # REG on real diagonal dims + identity on pad dims (= J + REG·I)
        return blocks[..., :S, :, :] + self.reg_eye.to(w.dtype)


def make_assembler(topo: Topology, sched: Schedule, device=None):
    """Returns assemble(w, ctx, params, mu) -> (..., S, W, W)."""
    from .core import resolve_device

    return Assembler(topo, sched, resolve_device(device))
