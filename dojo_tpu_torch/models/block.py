"""Free bodies with contacts: block and sphere (counterpart of
dojo_tpu/models/block.py)."""

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
