"""Mechanism construction: bodies + joints + contacts → (Topology, Params).

Counterpart of dojo_tpu/builder.py for what the quadruped needs: bodies
with explicit inertia, any joint kind of the masked joint kernel (floating
base, revolute, ...), sphere–halfspace contacts, joint limits, springs,
dampers and spring offsets.  Everything is computed host-side in numpy
float64 and moved to the device once, as one tensor per Params field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import lie, nplie
from .core import CONTACT_WIDTH, BodyState, Params, Topology, resolve_device, tensor_map

# joint kind → (Nλ_tra, Nλ_rot)
KIND_NLAM = {
    "fixed": (3, 3),
    "prismatic": (2, 3),
    "planar": (1, 3),
    "fixed_orientation": (0, 3),
    "revolute": (3, 2),
    "cylindrical": (2, 2),
    "planar_axis": (1, 2),
    "free_revolute": (0, 2),
    "orbital": (3, 1),
    "prismatic_orbital": (2, 1),
    "planar_orbital": (1, 1),
    "free_orbital": (0, 1),
    "spherical": (3, 0),
    "cylindrical_free": (2, 0),
    "planar_free": (1, 0),
    "floating": (0, 0),
}


@dataclasses.dataclass
class Body:
    name: str
    mass: float
    inertia: np.ndarray  # (3,3) or (3,) diagonal

    def inertia_matrix(self):
        J = np.asarray(self.inertia, dtype=np.float64)
        return np.diag(J) if J.ndim == 1 else J


@dataclasses.dataclass
class JointDef:
    kind: str
    parent: str  # body name or 'origin'
    child: str
    axis: Sequence = (1.0, 0.0, 0.0)
    rot_axis: Optional[Sequence] = None  # rotational-subjoint axis override
    parent_vertex: Sequence = (0.0, 0.0, 0.0)
    child_vertex: Sequence = (0.0, 0.0, 0.0)
    orientation_offset: Sequence = (1.0, 0.0, 0.0, 0.0)
    spring: float = 0.0
    damper: float = 0.0
    tra_spring_offset: Optional[Sequence] = None
    rot_spring_offset: Optional[Sequence] = None
    tra_limits: Optional[tuple] = None  # (lo, hi) arrays over free tra coords
    rot_limits: Optional[tuple] = None
    name: Optional[str] = None


@dataclasses.dataclass
class ContactDef:
    """A sphere on `body` against a static halfspace (the world)."""

    body: str
    kind: str = "nonlinear"
    normal: Sequence = (0.0, 0.0, 1.0)
    friction: float = 1.0
    origin: Sequence = (0.0, 0.0, 0.0)  # contact point in body frame
    radius: float = 0.0
    offset: Sequence = (0.0, 0.0, 0.0)  # halfspace offset in world frame
    name: Optional[str] = None


def _masks(axis, nlam):
    """Constraint/nullspace mask rows, zero-padded."""
    v1, v2, v3 = lie.orthogonal_rows(np.asarray(axis, dtype=np.float64))
    c = np.zeros((3, 3))
    n = np.zeros((3, 3))
    if nlam == 0:
        n[:] = np.eye(3)
    elif nlam == 1:
        c[0] = v3
        n[0], n[1] = v1, v2
    elif nlam == 2:
        c[0], c[1] = v1, v2
        n[0] = v3
    else:
        c[:] = np.eye(3)
    lam_mask = np.zeros(3)
    lam_mask[:nlam] = 1.0
    free_mask = np.zeros(3)
    free_mask[: 3 - nlam] = 1.0
    return c, n, lam_mask, free_mask


class Mechanism:
    """Built mechanism: static topology + parameter tensors + name maps."""

    def __init__(self, topo, params, body_names, joint_names, contact_names):
        self.topo = topo
        self.params = params
        self.body_names = list(body_names)
        self.joint_names = list(joint_names)
        self.contact_names = list(contact_names)
        self.body_index = {n: i for i, n in enumerate(body_names)}
        self.joint_index = {n: i for i, n in enumerate(joint_names)}

    @property
    def device(self) -> torch.device:
        return self.params.mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.params.mass.dtype

    def cast(self, dtype) -> "Mechanism":
        """Cast the floating-point params to ``dtype``.  Mutates and returns
        self."""
        self.params = tensor_map(
            lambda a: a.to(dtype) if a.is_floating_point() else a, self.params
        )
        return self

    def zero_state(self) -> BodyState:
        """Zero-coordinate forward-kinematics placement."""
        nb = self.topo.nb
        x = np.zeros((nb, 3))
        q = np.tile(np.array([1.0, 0, 0, 0]), (nb, 1))
        pv = self.params.tra_vertex_parent.cpu().double().numpy()
        cv = self.params.tra_vertex_child.cpu().double().numpy()
        off = self.params.rot_offset.cpu().double().numpy()
        for j in self.topo.root_to_leaves:
            if j in self.topo.loop_joints:
                continue
            p, c = self.topo.joint_parent[j], self.topo.joint_child[j]
            xa = np.zeros(3) if p < 0 else x[p]
            qa = np.array([1.0, 0, 0, 0]) if p < 0 else q[p]
            qb = nplie.qmul(qa, off[j])
            xb = xa + nplie.rotate(pv[j], qa) - nplie.rotate(cv[j], qb)
            x[c], q[c] = xb, qb
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        return BodyState(x=t(x), q=t(q), v=t(np.zeros((nb, 3))), w=t(np.zeros((nb, 3))))


def build(
    bodies: Sequence[Body],
    joints: Sequence[JointDef],
    contacts: Sequence[ContactDef] = (),
    timestep: float = 0.01,
    gravity=(0.0, 0.0, -9.81),
    dtype=torch.float64,
    device=None,
) -> Mechanism:
    device = resolve_device(device)
    nb, nj, nc = len(bodies), len(joints), len(contacts)
    body_names = [b.name for b in bodies]
    bidx = {"origin": -1, "world": -1}
    bidx.update({n: i for i, n in enumerate(body_names)})

    # limit pad width
    maxlim = 0
    for jd in joints:
        for lim in (jd.tra_limits, jd.rot_limits):
            if lim is not None:
                maxlim = max(maxlim, len(np.atleast_1d(lim[0])))
    cw = max((CONTACT_WIDTH[c.kind] for c in contacts), default=0)

    # topology ordering: BFS from the origin
    children = {}
    for j, jd in enumerate(joints):
        children.setdefault(bidx[jd.parent], []).append(j)
    order, seen_bodies, loop = [], {-1}, []
    frontier = [-1]
    while frontier:
        b = frontier.pop(0)
        for j in children.get(b, []):
            c = bidx[joints[j].child]
            if c in seen_bodies:
                loop.append(j)
                continue
            order.append(j)
            seen_bodies.add(c)
            frontier.append(c)
    for j in range(nj):  # loop-closing joints appended last
        if j not in order:
            if j not in loop:
                loop.append(j)
            order.append(j)

    topo = Topology(
        nb=nb,
        nj=nj,
        nc=nc,
        maxlim=maxlim,
        cw=cw,
        joint_parent=tuple(bidx[j.parent] for j in joints),
        joint_child=tuple(bidx[j.child] for j in joints),
        contact_parent=tuple(bidx[c.body] for c in contacts),
        contact_child=tuple(-1 for _ in contacts),
        contact_kind=tuple(c.kind for c in contacts),
        contact_geom=tuple("halfspace" for _ in contacts),
        tra_nfree=tuple(3 - KIND_NLAM[j.kind][0] for j in joints),
        rot_nfree=tuple(3 - KIND_NLAM[j.kind][1] for j in joints),
        root_to_leaves=tuple(order),
        loop_joints=tuple(loop),
    )

    zeros = lambda *s: np.zeros(s)
    tra_cmask, tra_nmask = zeros(nj, 3, 3), zeros(nj, 3, 3)
    rot_cmask, rot_nmask = zeros(nj, 3, 3), zeros(nj, 3, 3)
    tra_lam, tra_free = zeros(nj, 3), zeros(nj, 3)
    rot_lam, rot_free = zeros(nj, 3), zeros(nj, 3)
    tvp, tvc = zeros(nj, 3), zeros(nj, 3)
    roff = np.tile(np.array([1.0, 0, 0, 0]), (nj, 1))
    t_spring, t_damper = zeros(nj), zeros(nj)
    r_spring, r_damper = zeros(nj), zeros(nj)
    t_soff, r_soff = zeros(nj, 3), zeros(nj, 3)
    ML = maxlim
    t_lo, t_hi, t_lm = zeros(nj, ML), zeros(nj, ML), zeros(nj, ML)
    r_lo, r_hi, r_lm = zeros(nj, ML), zeros(nj, ML), zeros(nj, ML)

    for j, jd in enumerate(joints):
        nl_t, nl_r = KIND_NLAM[jd.kind]
        tra_cmask[j], tra_nmask[j], tra_lam[j], tra_free[j] = _masks(jd.axis, nl_t)
        rot_cmask[j], rot_nmask[j], rot_lam[j], rot_free[j] = _masks(
            jd.axis if jd.rot_axis is None else jd.rot_axis, nl_r
        )
        tvp[j] = np.asarray(jd.parent_vertex, dtype=np.float64)
        tvc[j] = np.asarray(jd.child_vertex, dtype=np.float64)
        o = np.asarray(jd.orientation_offset, dtype=np.float64)
        roff[j] = o / np.linalg.norm(o)
        t_spring[j] = r_spring[j] = jd.spring
        t_damper[j] = r_damper[j] = jd.damper
        if jd.tra_spring_offset is not None:
            t_soff[j, : 3 - nl_t] = np.atleast_1d(jd.tra_spring_offset)
        if jd.rot_spring_offset is not None:
            r_soff[j, : 3 - nl_r] = np.atleast_1d(jd.rot_spring_offset)
        if jd.tra_limits is not None:
            lo, hi = (np.atleast_1d(v) for v in jd.tra_limits)
            t_lo[j, : len(lo)], t_hi[j, : len(hi)] = lo, hi
            t_lm[j, : len(lo)] = 1.0
        if jd.rot_limits is not None:
            lo, hi = (np.atleast_1d(v) for v in jd.rot_limits)
            r_lo[j, : len(lo)], r_hi[j, : len(hi)] = lo, hi
            r_lm[j, : len(lo)] = 1.0

    # contact normal/tangent rows from the orthogonal complement of the normal
    c_fric, c_rad = zeros(nc), zeros(nc)
    c_norm, c_orig, c_off = zeros(nc, 3), zeros(nc, 3), zeros(nc, 3)
    c_tan = zeros(nc, 2, 3)
    for c, cd in enumerate(contacts):
        v1, v2, v3 = lie.orthogonal_rows(np.asarray(cd.normal, dtype=np.float64))
        Ainv = np.linalg.inv(np.stack([v1, v2, v3], axis=1))
        c_norm[c] = Ainv[2]
        c_tan[c] = Ainv[:2]
        c_fric[c] = cd.friction
        c_orig[c] = np.asarray(cd.origin, dtype=np.float64)
        c_rad[c] = cd.radius
        c_off[c] = np.asarray(cd.offset, dtype=np.float64)

    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
    params = Params(
        mass=t([b.mass for b in bodies]),
        inertia=t(np.stack([b.inertia_matrix() for b in bodies]) if nb else zeros(0, 3, 3)),
        tra_cmask=t(tra_cmask),
        tra_nmask=t(tra_nmask),
        tra_lam_mask=t(tra_lam),
        tra_free_mask=t(tra_free),
        tra_vertex_parent=t(tvp),
        tra_vertex_child=t(tvc),
        tra_spring=t(t_spring),
        tra_damper=t(t_damper),
        tra_spring_offset=t(t_soff),
        tra_lim_lo=t(t_lo),
        tra_lim_hi=t(t_hi),
        tra_lim_mask=t(t_lm),
        rot_cmask=t(rot_cmask),
        rot_nmask=t(rot_nmask),
        rot_lam_mask=t(rot_lam),
        rot_free_mask=t(rot_free),
        rot_offset=t(roff),
        rot_spring=t(r_spring),
        rot_damper=t(r_damper),
        rot_spring_offset=t(r_soff),
        rot_lim_lo=t(r_lo),
        rot_lim_hi=t(r_hi),
        rot_lim_mask=t(r_lm),
        contact_friction=t(c_fric),
        contact_normal=t(c_norm),
        contact_tangent=t(c_tan),
        contact_origin=t(c_orig),
        contact_radius=t(c_rad),
        contact_offset=t(c_off),
        contact_child_origin=t(zeros(nc, 3)),
        contact_child_radius=t(zeros(nc)),
        contact_aux=t(zeros(nc, 6)),
        gravity=t(gravity),
        timestep=t(timestep),
    )
    return Mechanism(
        topo,
        params,
        body_names,
        [jd.name or f"joint_{i}" for i, jd in enumerate(joints)],
        [cd.name or f"contact_{i}" for i, cd in enumerate(contacts)],
    )
