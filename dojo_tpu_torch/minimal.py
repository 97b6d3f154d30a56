"""Minimal ↔ maximal coordinate conversions (counterpart of dojo_tpu/minimal.py).

Minimal state layout: per joint, in joint-id order,
[Δx(nu_tra); Δθ(nu_rot); Δv(nu_tra); Δω(nu_rot)].  Both directions take
one unbatched state; the root→leaves propagation unrolls over the topology.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import joints as jk
from . import lie
from .core import BodyState, Params, Topology
from .joints import mv
from .residual import joint_params


def _joint_slices(topo: Topology):
    """Static per-joint offsets into the minimal vector."""
    sl = []
    off = 0
    for j in range(topo.nj):
        nt, nr = topo.tra_nfree[j], topo.rot_nfree[j]
        sl.append((off, nt, nr))
        off += 2 * (nt + nr)
    return sl, off


def _joint(jp_all, j):
    return {k: a[j] for k, a in jp_all.items()}


def minimal_to_maximal(topo: Topology, params: Params, y) -> BodyState:
    """Root-to-leaves forward kinematics from minimal coordinates+velocities."""
    dtype, dev = y.dtype, y.device
    h = params.timestep
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    qid = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)
    x = [z3] * topo.nb
    q = [qid] * topo.nb
    v = [z3] * topo.nb
    w = [z3] * topo.nb
    slices, _ = _joint_slices(topo)
    jp_all = joint_params(params)
    pad3 = lambda a: F.pad(a, (0, 3 - a.shape[-1]))

    for j in topo.root_to_leaves:
        if j in topo.loop_joints:
            continue  # loop-closing joints don't place bodies
        off, nt, nr = slices[j]
        dx3 = pad3(y[off : off + nt])
        dth3 = pad3(y[off + nt : off + nt + nr])
        dv3 = pad3(y[off + nt + nr : off + 2 * nt + nr])
        dw3 = pad3(y[off + 2 * nt + nr : off + 2 * (nt + nr)])
        p, c = topo.joint_parent[j], topo.joint_child[j]
        if p < 0:
            xa, qa, va, wa = z3, qid, z3, z3
        else:
            xa, qa, va, wa = x[p], q[p], v[p], w[p]
        jpj = _joint(jp_all, j)
        At = jpj["tra_nmask"].T
        Ar = jpj["rot_nmask"].T
        pa, pb = jpj["tra_vertex_parent"], jpj["tra_vertex_child"]
        offq = jpj["rot_offset"]

        dq = lie.axis_angle_to_quaternion(mv(Ar, dth3))
        qb = lie.qmul(qa, lie.qmul(offq, dq))
        xb = xa + lie.rotate(pa + mv(At, dx3), qa) - lie.rotate(pb, qb)

        # velocities via a one-step finite difference
        xa1 = lie.next_position(xa, -va, h)
        qa1 = lie.next_orientation(qa, -wa, h)
        dx1 = dx3 - dv3 * h
        dq1 = lie.qmul(dq, lie.qconj(lie.axis_angle_to_quaternion(mv(Ar, dw3 * h))))
        qb1 = lie.qmul(qa1, lie.qmul(offq, dq1))
        xb1 = xa1 + lie.rotate(pa + mv(At, dx1), qa1) - lie.rotate(pb, qb1)
        x[c], q[c] = xb, qb
        v[c], w[c] = (xb - xb1) / h, lie.angular_velocity(qb1, qb, h)
    st = lambda rows: torch.stack(rows) if rows else torch.zeros(0, 3, dtype=dtype, device=dev)
    return BodyState(x=st(x), q=st(q), v=st(v), w=st(w))


def maximal_to_minimal(topo: Topology, params: Params, state: BodyState):
    """Per-joint relative coordinates and velocities."""
    dtype, dev = state.x.dtype, state.x.device
    h = params.timestep
    z3 = torch.zeros(1, 3, dtype=dtype, device=dev)
    qid = torch.tensor([[1.0, 0, 0, 0]], dtype=dtype, device=dev)
    xa = torch.cat([z3, state.x])
    qa = torch.cat([qid, state.q])
    va = torch.cat([z3, state.v])
    wa = torch.cat([z3, state.w])
    jp_all = joint_params(params)
    parts = []
    for j in range(topo.nj):
        p, c = topo.joint_parent[j] + 1, topo.joint_child[j] + 1
        nt, nr = topo.tra_nfree[j], topo.rot_nfree[j]
        jpj = _joint(jp_all, j)
        args = (jpj, xa[p], qa[p], xa[c], qa[c])
        vargs = (jpj, xa[p], va[p], qa[p], wa[p], xa[c], va[c], qa[c], wa[c], h)
        parts.extend([
            jk.tra_minimal_coordinates(*args)[:nt],
            jk.rot_minimal_coordinates(*args)[:nr],
            jk.tra_minimal_velocities(*vargs)[:nt],
            jk.rot_minimal_velocities(*vargs)[:nr],
        ])
    if not parts:
        return torch.zeros(0, dtype=dtype, device=dev)
    return torch.cat(parts)


def set_joint_minimal(topo: Topology, params: Params, state: BodyState, joint_index,
                      coords=None, velocities=None) -> BodyState:
    """Overwrite one joint's minimal coordinates and/or velocities, keeping
    every other joint's: a round trip through the whole minimal vector, so
    the bodies downstream of the joint move with it."""
    y = maximal_to_minimal(topo, params, state).clone()
    off, nt, nr = _joint_slices(topo)[0][joint_index]
    as_y = lambda v: torch.as_tensor(v, dtype=y.dtype, device=y.device).reshape(-1)
    if coords is not None:
        y[off : off + nt + nr] = as_y(coords)
    if velocities is not None:
        y[off + nt + nr : off + 2 * (nt + nr)] = as_y(velocities)
    return minimal_to_maximal(topo, params, y)
