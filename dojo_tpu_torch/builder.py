"""Mechanism construction: bodies + joints + contacts → (Topology, Params).

Counterpart of dojo_tpu/builder.py for what the ported models need: bodies
with explicit inertia or the inertia of a box, cylinder, sphere, capsule or
pyramid, any joint kind of the masked joint kernel (floating base,
revolute, ...), loop-closing joints, sphere–halfspace contacts, joint
limits, springs, dampers and spring offsets; and, on the definition lists
before ``build``, the merge of bodies across fixed joints
(``reduce_fixed_joints``) and the re-rooting of a chain
(``set_floating_base``).  Everything is computed host-side in numpy
float64 and moved to the device once, as one tensor per Params field.
``Mechanism`` also carries dojo_tpu's surface: step and simulate, the
parameters by body, joint or contact name, the flat data vector, and the
minimal ↔ maximal state maps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import lie, nplie
from .core import (
    CONTACT_WIDTH,
    BodyState,
    Params,
    SolverOptions,
    Topology,
    resolve_device,
    tensor_map,
)

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
    shape: Optional[dict] = None  # geometry: contact radii and lengths, visuals

    def inertia_matrix(self):
        J = np.asarray(self.inertia, dtype=np.float64)
        return np.diag(J) if J.ndim == 1 else J


def box_body(name, x, y, z, mass):
    """A solid box of edges x, y, z."""
    J = mass / 12.0 * np.diag([y**2 + z**2, x**2 + z**2, x**2 + y**2])
    return Body(name, mass, J, shape={"type": "box", "xyz": (x, y, z)})


def cylinder_body(name, r, h, mass):
    """A solid cylinder of radius r and height h along z."""
    J = mass * np.diag([(3 * r**2 + h**2) / 12, (3 * r**2 + h**2) / 12, r**2 / 2])
    return Body(name, mass, J, shape={"type": "cylinder", "rh": (r, h)})


def sphere_body(name, r, mass):
    """A solid sphere of radius r."""
    J = mass * 2.0 / 5.0 * r**2 * np.eye(3)
    return Body(name, mass, J, shape={"type": "sphere", "r": r})


def capsule_body(name, r, h, mass):
    """A solid capsule: a cylinder of radius r and length h along z and two
    hemispherical caps, the mass split by volume, each cap's inertia moved
    by the parallel-axis rule to its centroid at 3r/8 + h/2."""
    vol_cyl = np.pi * h * r**2
    vol_hemi = np.pi * 4.0 / 3.0 * r**3 / 2.0
    m_cyl = mass * vol_cyl / (vol_cyl + 2 * vol_hemi)
    m_hemi = mass * vol_hemi / (vol_cyl + 2 * vol_hemi)
    ixx_cyl = m_cyl * (h**2 / 12.0 + r**2 / 4.0)
    izz_cyl = m_cyl * r**2 / 2.0
    ixx_hemi = 83.0 / 320.0 * m_hemi * r**2
    izz_hemi = m_hemi * 2.0 / 5.0 * r**2 / 2.0
    d = 3.0 / 8.0 * r + 0.5 * h
    ixx = ixx_cyl + 2.0 * (ixx_hemi + m_hemi * d**2)
    izz = izz_cyl + 2.0 * izz_hemi
    return Body(name, mass, np.diag([ixx, ixx, izz]), shape={"type": "capsule", "rh": (r, h)})


def pyramid_body(name, w, h, mass):
    """A solid square pyramid of base w and height h pointing +z (its COM
    at h/4 above the base)."""
    J = mass / 80.0 * np.diag([4 * w**2 + 3 * h**2, 4 * w**2 + 3 * h**2, 8 * w**2])
    return Body(name, mass, J, shape={"type": "pyramid", "wh": (w, h)})


def mesh_body(name, mass, inertia, path=None, scale=(1.0, 1.0, 1.0)):
    """A body of explicit inertia drawn as a mesh (the file is kept by name:
    the simulation never reads it)."""
    return Body(name, mass, np.asarray(inertia),
                shape={"type": "mesh", "path": path, "scale": tuple(scale)})


def combined_body(name, mass, inertia, shapes):
    """A body of explicit inertia drawn as a list of shape dicts."""
    return Body(name, mass, np.asarray(inertia), shape={"type": "combined", "shapes": list(shapes)})


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


def reduce_fixed_joints(bodies, joints, contacts=()):
    """Merge bodies across body–body fixed joints → (bodies, joints,
    contacts), new lists.

    The merged body keeps the parent's name and orientation; its origin
    moves to the combined COM, its inertia is the parallel-axis sum.  The
    joints and contacts on either body are moved into the merged frame: on
    the child they are carried through the fixed joint's offset (a joint
    whose parent was the child rotates its translational axis and keeps its
    rotational one; a joint whose child was the child rotates its
    rotational axis).  Fixed joints to the origin stay as constraints."""
    import copy

    bodies = [copy.deepcopy(b) for b in bodies]
    joints = [copy.deepcopy(j) for j in joints]
    contacts = [copy.deepcopy(c) for c in contacts]
    f64 = lambda v: np.asarray(v, dtype=np.float64)

    def kmat(d):
        d = f64(d)
        return float(d @ d) * np.eye(3) - np.outer(d, d)

    while True:
        jfix = next((j for j in joints if j.kind == "fixed" and j.parent != "origin"), None)
        if jfix is None:
            return bodies, joints, contacts
        p = next(b for b in bodies if b.name == jfix.parent)
        c = next(b for b in bodies if b.name == jfix.child)
        off = f64(jfix.orientation_offset)
        R = nplie.rotation_matrix(off)
        delta = f64(jfix.parent_vertex) - R @ f64(jfix.child_vertex)  # child origin, parent frame
        m = p.mass + c.mass
        s = c.mass / m * delta  # the combined COM in the parent's frame
        Jp = p.inertia_matrix() + p.mass * kmat(-s)
        Jc = R @ c.inertia_matrix() @ R.T + c.mass * kmat(delta - s)
        p.mass = m
        p.inertia = Jp + Jc
        to_parent = lambda v: R @ f64(v) + delta - s
        for jd in joints:
            if jd is jfix:
                continue
            if jd.parent == p.name:
                jd.parent_vertex = f64(jd.parent_vertex) - s
            elif jd.child == p.name:
                jd.child_vertex = f64(jd.child_vertex) - s
            elif jd.parent == c.name:
                jd.parent = p.name
                jd.parent_vertex = to_parent(jd.parent_vertex)
                if jd.rot_axis is None:
                    jd.rot_axis = f64(jd.axis)
                jd.axis = R @ f64(jd.axis)
                jd.orientation_offset = nplie.qmul(off, f64(jd.orientation_offset))
            elif jd.child == c.name:
                jd.child = p.name
                jd.child_vertex = to_parent(jd.child_vertex)
                jd.rot_axis = R @ f64(jd.axis if jd.rot_axis is None else jd.rot_axis)
                jd.orientation_offset = nplie.qmul(f64(jd.orientation_offset), nplie.qconj(off))
        for cd in contacts:
            if cd.body == p.name:
                cd.origin = f64(cd.origin) - s
            elif cd.body == c.name:
                cd.body = p.name
                cd.origin = to_parent(cd.origin)
        joints.remove(jfix)
        bodies.remove(c)


def set_floating_base(bodies, joints, name):
    """Re-root the chain so that body ``name`` hangs off the origin's joint
    → (bodies, joints), new lists.

    Each joint on the path from the origin's subtree root to ``name`` swaps
    parent and child and their vertices, inverts its orientation offset, and
    maps its axes so that its minimal coordinates keep their meaning: the
    rotational axis to −R(off)·axis, the translational to −R(off)ᵀ·axis.
    The origin's joint keeps its kind and takes ``name`` as its child.
    Contacts are attached to bodies and need no change."""
    import copy

    bodies = [copy.deepcopy(b) for b in bodies]
    joints = [copy.deepcopy(j) for j in joints]
    f64 = lambda v: np.asarray(v, dtype=np.float64)
    child_to_joint = {}
    for jd in joints:
        if jd.child in child_to_joint:
            raise ValueError(f"set_floating_base: body '{jd.child}' has several parent joints "
                             "(a kinematic loop); re-rooting a loop is not supported")
        child_to_joint[jd.child] = jd
    if name not in child_to_joint:
        raise ValueError(f"set_floating_base: unknown body '{name}'")
    chain = [child_to_joint[name]]
    while chain[-1].parent not in ("origin", "world"):
        chain.append(child_to_joint[chain[-1].parent])
    for jd in chain:
        if jd.parent in ("origin", "world"):
            jd.child = name
            continue
        off = f64(jd.orientation_offset)
        R = nplie.rotation_matrix(off)
        jd.parent, jd.child = jd.child, jd.parent
        jd.parent_vertex, jd.child_vertex = f64(jd.child_vertex), f64(jd.parent_vertex)
        jd.rot_axis = -R @ f64(jd.axis if jd.rot_axis is None else jd.rot_axis)
        jd.axis = -R.T @ f64(jd.axis)
        jd.orientation_offset = nplie.qconj(off)
    return bodies, joints


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

    def __init__(self, topo, params, body_names, joint_names, contact_names, body_shapes=None):
        self.topo = topo
        self.params = params
        self.body_names = list(body_names)
        self.body_shapes = list(body_shapes or [None] * len(self.body_names))
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

    @property
    def input_dim(self) -> int:
        return self.topo.input_dim

    @property
    def minimal_dim(self) -> int:
        return self.topo.minimal_dim

    @property
    def timestep(self) -> float:
        return float(self.params.timestep)

    def _cached(self, key, make):
        cache = self.__dict__.setdefault("_fn_cache", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def _lanes(self, state):
        """(state with a lane axis, whether one was added)."""
        if state.x.ndim == 2:
            return tensor_map(lambda a: a[None], state), True
        return state, False

    def step(self, state, u=None, opts=None, params=None):
        """One simulation step (maximal in and out): (state', StepInfo).

        state: (nb, k) fields, or (B, nb, k) for B lanes; u: packed inputs
        (input_dim,) or (B, input_dim), or None."""
        from .residual import pad_inputs
        from .simulate import make_step

        opts = opts or SolverOptions()
        fn = self._cached(("step", opts), lambda: make_step(self.topo, opts, self.device))
        state, one = self._lanes(state)
        up = None
        if u is not None:
            u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
            up = pad_inputs(self.topo, u.expand(state.x.shape[0], self.input_dim))
        nxt, info = fn(self.params if params is None else params, state, up)
        if one:
            nxt, info = tensor_map(lambda a: a[0], nxt), tensor_map(lambda a: a[0], info)
        return nxt, info

    def simulate(self, state, horizon, us=None, opts=None, params=None):
        """Rollout for ``horizon`` steps → (final state, Trajectory);
        us: packed inputs (T, input_dim) or (T, B, input_dim), or None.  A
        state without a lane axis gives a trajectory without one."""
        from .residual import pad_inputs
        from .simulate import Trajectory, make_simulate

        opts = opts or SolverOptions()
        fn = self._cached(("simulate", opts), lambda: make_simulate(self.topo, opts, self.device))
        state, one = self._lanes(state)
        if us is not None:
            us = torch.as_tensor(us, dtype=self.dtype, device=self.device)
            us = us[:, None] if us.ndim == 2 else us
            us = pad_inputs(self.topo, us.expand(-1, state.x.shape[0], -1))
        final, traj = fn(self.params if params is None else params, state, us, horizon=horizon)
        if one:
            drop = lambda a: a[:, 0]
            final = tensor_map(lambda a: a[0], final)
            traj = Trajectory(*(drop(getattr(traj, f)) for f in "xqvw"),
                              info=tensor_map(drop, traj.info))
        return final, traj

    # -- parameter get/set by name ----------------------------------------------
    _BODY_FIELDS = {"mass": "mass", "inertia": "inertia"}
    _JOINT_FIELDS = {
        "spring": ("tra_spring", "rot_spring"),
        "damper": ("tra_damper", "rot_damper"),
        "parent_vertex": ("tra_vertex_parent",),
        "child_vertex": ("tra_vertex_child",),
        "orientation_offset": ("rot_offset",),
    }
    _CONTACT_FIELDS = {
        "friction": "contact_friction",
        "origin": "contact_origin",
        "radius": "contact_radius",
        "offset": "contact_offset",
    }

    def get_body(self, name):
        """A body's parameters by name: {mass, inertia}."""
        i = self.body_index[name]
        return {k: getattr(self.params, f)[i] for k, f in self._BODY_FIELDS.items()}

    def get_joint(self, name):
        i = self.joint_index[name]
        return {k: getattr(self.params, fs[0])[i] for k, fs in self._JOINT_FIELDS.items()}

    def get_contact(self, name):
        i = self.contact_names.index(name)
        return {k: getattr(self.params, f)[i] for k, f in self._CONTACT_FIELDS.items()}

    def _set_rows(self, index, mapping, kwargs):
        p = self.params
        for k, v in kwargs.items():
            fields = mapping[k]
            for f in (fields,) if isinstance(fields, str) else fields:
                arr = getattr(p, f).clone()
                arr[index] = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
                p = dataclasses.replace(p, **{f: arr})
        return p

    def set_body(self, name, **kwargs):
        """Update a body's rows (new tensors); stores and returns the Params."""
        self.params = self._set_rows(self.body_index[name], self._BODY_FIELDS, kwargs)
        return self.params

    def set_joint(self, name, **kwargs):
        self.params = self._set_rows(self.joint_index[name], self._JOINT_FIELDS, kwargs)
        return self.params

    def set_contact(self, name, **kwargs):
        self.params = self._set_rows(self.contact_names.index(name), self._CONTACT_FIELDS,
                                     kwargs)
        return self.params

    # -- the flat data vector of the physical parameters -------------------------
    # dojo_tpu's order, so that one vector means the same in both packages
    _DATA_FIELDS = (
        "mass", "inertia",
        "tra_spring", "tra_damper", "tra_vertex_parent", "tra_vertex_child",
        "tra_spring_offset", "rot_spring", "rot_damper", "rot_offset",
        "rot_spring_offset",
        "contact_friction", "contact_radius", "contact_origin",
        "contact_offset", "contact_child_origin", "contact_child_radius",
        "contact_aux", "gravity", "timestep",
    )

    def get_data(self, params=None):
        """Flat vector of every physical parameter (masses, inertias, joint
        springs, dampers, vertices and offsets, contact geometry and
        friction, gravity, timestep) in ``_DATA_FIELDS`` order."""
        p = self.params if params is None else params
        return torch.cat([getattr(p, f).reshape(-1) for f in self._DATA_FIELDS])

    def with_data(self, vec, params=None):
        """get_data's inverse: Params with the flat vector scattered back into
        the physical fields, differentiably (for system identification over
        the whole vector inside a loss)."""
        p = self.params if params is None else params
        out, i = {}, 0
        for f in self._DATA_FIELDS:
            a = getattr(p, f)
            out[f] = vec[i : i + a.numel()].reshape(a.shape).to(a.dtype)
            i += a.numel()
        return dataclasses.replace(p, **out)

    def set_data(self, vec):
        """Store the Params of a data vector; returns them."""
        self.params = self.with_data(vec)
        return self.params

    def minimal_state(self, state):
        """Minimal coordinates of a state, (ny,) or (B, ny) with lanes."""
        from .gradients import to_minimal
        from .minimal import maximal_to_minimal

        if state.x.ndim == 2:
            return maximal_to_minimal(self.topo, self.params, state)
        return to_minimal(self.topo, self.params, state)

    def maximal_state(self, y):
        """The maximal state of minimal coordinates y, (ny,) or (B, ny)."""
        from .gradients import to_maximal
        from .minimal import minimal_to_maximal

        if y.ndim == 1:
            return minimal_to_maximal(self.topo, self.params, y)
        return to_maximal(self.topo, self.params, y)

    def set_minimal(self, state, joint, coords=None, velocities=None):
        """A state with one joint's (index or name) minimal coordinates and/or
        velocities overwritten (one state, no lane axis)."""
        from .minimal import set_joint_minimal

        j = joint if isinstance(joint, int) else self.joint_index[joint]
        return set_joint_minimal(self.topo, self.params, state, j, coords, velocities)

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
        [b.shape for b in bodies],
    )
