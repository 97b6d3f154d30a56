"""Chain mechanisms: snake and twister (counterpart of
dojo_tpu/models/snake.py)."""

import dataclasses

import numpy as np
import torch

from .. import builder as bd
from . import register, register_init

X, Y, Z = np.eye(3)
KINDMAP = {"Spherical": "spherical", "Revolute": "revolute", "Orbital": "orbital",
           "Prismatic": "prismatic", "Cylindrical": "cylindrical",
           "Planar": "planar", "Fixed": "fixed"}


def _chain(name, num_bodies, link_length, radius, joint_type, axes, springs, dampers,
           friction_coefficient, contact, contact_type, timestep, gravity, dtype, device):
    bodies = [
        bd.box_body(f"{name}{i}", link_length, 3 * radius, 2 * radius, link_length)
        for i in range(num_bodies)
    ]
    joints = [bd.JointDef(kind="floating", parent="origin", child=f"{name}0")]
    for i in range(1, num_bodies):
        joints.append(
            bd.JointDef(
                kind=KINDMAP.get(joint_type, joint_type),
                parent=f"{name}{i-1}",
                child=f"{name}{i}",
                axis=axes[i % len(axes)],
                parent_vertex=-X * link_length / 2,
                child_vertex=X * link_length / 2,
                spring=springs,
                damper=dampers,
            )
        )
    contacts = []
    if contact:
        for i in range(num_bodies):
            for sgn, tag in ((1.0, "f"), (-1.0, "b")):
                contacts.append(
                    bd.ContactDef(body=f"{name}{i}", kind=contact_type, normal=Z,
                                  friction=friction_coefficient,
                                  origin=sgn * X * link_length / 2, name=f"contact_{tag}{i}")
                )
    return bd.build(bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


def _lifted(mech, position):
    """The zero state with every body moved by ``position``."""
    s = mech.zero_state()
    return dataclasses.replace(
        s, x=s.x + torch.as_tensor(position, dtype=s.x.dtype, device=s.x.device))


@register("snake")
def get_snake(timestep=0.01, gravity=-9.81, num_bodies=2, link_length=1.0, radius=0.05,
              springs=0.0, dampers=0.0, joint_type="Spherical", friction_coefficient=0.8,
              contact=True, contact_type="nonlinear", dtype=torch.float64, device=None):
    return _chain("snake", num_bodies, link_length, radius, joint_type, [X], springs, dampers,
                  friction_coefficient, contact, contact_type, timestep, gravity, dtype, device)


@register_init("snake")
def initialize_snake(mech, base_position=(0, 0, 1.0), base_orientation=(1.0, 0, 0, 0)):
    return _lifted(mech, base_position)


@register("twister")
def get_twister(timestep=0.01, gravity=-9.81, num_bodies=5, height=1.0, radius=0.05,
                springs=0.0, dampers=0.0, joint_type="Prismatic", friction_coefficient=0.8,
                contact=True, contact_type="nonlinear", dtype=torch.float64, device=None):
    axes = [Y, Z, X]
    return _chain("twist", num_bodies, height, radius, joint_type, axes, springs, dampers,
                  friction_coefficient, contact, contact_type, timestep, gravity, dtype, device)


@register_init("twister")
def initialize_twister(mech, base_position=(0, 0, 2.0)):
    return _lifted(mech, base_position)
