"""Free bodies: block and sphere with contacts, the dzhanibekov T-handle and
the tippetop (counterpart of dojo_tpu/models/block.py)."""

import dataclasses

import numpy as np
import torch

from .. import builder as bd
from ..core import BodyState
from . import register, register_init

X, Y, Z = np.eye(3)


@register("block")
def get_block(
    timestep=0.01,
    gravity=-9.81,
    mass=1.0,
    edge_length=0.5,
    friction_coefficient=0.8,
    contact=True,
    contact_radius=0.0,
    contact_type="nonlinear",
    dtype=torch.float64,
    device=None,
):
    block = bd.box_body("block", edge_length, edge_length, edge_length, mass)
    joint = bd.JointDef(kind="floating", parent="origin", child="block")
    contacts = []
    if contact:
        e = edge_length / 2
        corners = [
            [e, e, -e], [e, -e, -e], [-e, e, -e], [-e, -e, -e],
            [e, e, e], [e, -e, e], [-e, e, e], [-e, -e, e],
        ]
        contacts = [
            bd.ContactDef(body="block", kind=contact_type, normal=Z,
                          friction=friction_coefficient, origin=c, radius=contact_radius,
                          name=f"contact{i}")
            for i, c in enumerate(corners)
        ]
    return bd.build([block], [joint], contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("block")
def initialize_block(mech, position=(0, 0, 1.0), orientation=(1.0, 0, 0, 0), velocity=(0, 0, 0),
                     angular_velocity=(0, 0, 0)):
    t = lambda a: torch.as_tensor([a], dtype=mech.dtype, device=mech.device)
    q = t(orientation)
    return BodyState(x=t(position), q=q / torch.linalg.vector_norm(q), v=t(velocity),
                     w=t(angular_velocity))


@register("sphere")
def get_sphere(
    timestep=0.01,
    gravity=-9.81,
    mass=1.0,
    radius=0.5,
    friction_coefficient=0.8,
    contact=True,
    contact_type="nonlinear",
    dtype=torch.float64,
    device=None,
):
    sphere = bd.sphere_body("sphere", radius, mass)
    joint = bd.JointDef(kind="floating", parent="origin", child="sphere")
    contacts = [
        bd.ContactDef(body="sphere", kind=contact_type, normal=Z,
                      friction=friction_coefficient, radius=radius)
    ] if contact else []
    return bd.build([sphere], [joint], contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("sphere")
def initialize_sphere(mech, position=(0, 0, 0.5), orientation=(1.0, 0, 0, 0),
                      velocity=(1.0, 0, 0), angular_velocity=(0, 0, 0)):
    return initialize_block(mech, position, orientation, velocity, angular_velocity)


@register("dzhanibekov")
def get_dzhanibekov(timestep=0.01, gravity=0.0, mass=1.0, dtype=torch.float64, device=None):
    """A tumbling T-handle: an asymmetric rigid body (two boxes welded by a
    fixed joint) for the intermediate-axis instability."""
    main = bd.box_body("main", 0.1, 0.1, 1.0, mass)
    side = bd.box_body("side", 0.1, 0.1, 0.4, mass / 2)
    joints = [
        bd.JointDef(kind="floating", parent="origin", child="main"),
        bd.JointDef(kind="fixed", parent="main", child="side", parent_vertex=[0.1, 0, 0],
                    child_vertex=[0, 0, -0.2],
                    orientation_offset=[np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0]),
    ]
    return bd.build([main, side], joints, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


def _spun(mech, state, angular_velocity):
    """``state`` with the floating base's angular velocity (minimal
    coordinates 9:12) set."""
    from ..minimal import maximal_to_minimal, minimal_to_maximal

    y = maximal_to_minimal(mech.topo, mech.params, state).clone()
    y[9:12] = torch.as_tensor(angular_velocity, dtype=y.dtype, device=y.device)
    return minimal_to_maximal(mech.topo, mech.params, y)


@register_init("dzhanibekov")
def initialize_dzhanibekov(mech, angular_velocity=(2.0, 0.01, 0.0)):
    return _spun(mech, mech.zero_state(), angular_velocity)


@register("tippetop")
def get_tippetop(timestep=0.01, gravity=-9.81, friction_coefficient=0.4, contact=True,
                 contact_type="nonlinear", dtype=torch.float64, device=None):
    """A spinning top that flips upside down: a ball and a smaller stem
    sphere welded above it, each with a contact."""
    r1, r2 = 0.5, 0.175
    ball = bd.sphere_body("ball", r1, 1.0)
    stem = bd.sphere_body("stem", r2, 0.2)
    joints = [
        bd.JointDef(kind="floating", parent="origin", child="ball"),
        bd.JointDef(kind="fixed", parent="ball", child="stem", parent_vertex=[0, 0, r1 + r2 / 2]),
    ]
    contacts = [
        bd.ContactDef(body="ball", kind=contact_type, normal=Z, friction=friction_coefficient,
                      radius=r1),
        bd.ContactDef(body="stem", kind=contact_type, normal=Z, friction=friction_coefficient,
                      radius=r2),
    ] if contact else []
    return bd.build([ball, stem], joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("tippetop")
def initialize_tippetop(mech, angular_velocity=(0.01, 0.0, 50.0)):
    s = mech.zero_state()
    s = dataclasses.replace(s, x=s.x + torch.as_tensor([0.0, 0.0, 0.5], dtype=s.x.dtype,
                                                       device=s.x.device))
    return _spun(mech, s, angular_velocity)
