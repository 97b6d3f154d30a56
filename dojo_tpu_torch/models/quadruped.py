"""Quadruped (Unitree A1): gazebo_a1.urdf, floating base, 12 revolute
joints with limits and spring offsets, 12 sphere–halfspace contacts on the
feet, thighs and hips (counterpart of dojo_tpu/models/quadruped.py)."""

import os

import numpy as np
import torch

from .. import builder as bd
from ..minimal import _joint_slices, maximal_to_minimal, minimal_to_maximal
from ..urdf import apply_zoo_options, parse_urdf_defs
from . import register, register_init

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
Z = np.array([0.0, 0.0, 1.0])
GROUPS = ["FR", "FL", "RR", "RL"]


@register("quadruped")
def get_quadruped(
    timestep=0.01,
    gravity=-9.81,
    urdf="gazebo_a1",
    springs=0.0,
    dampers=0.0,
    parse_springs=True,
    parse_dampers=True,
    spring_offset=True,
    limits=True,
    friction_coefficient=0.8,
    contact_feet=True,
    contact_body=True,
    dtype=torch.float64,
    device=None,
):
    bodies, joints = parse_urdf_defs(
        os.path.join(ASSETS, f"{urdf}.urdf"), floating=True,
        parse_dampers=parse_dampers,
    )
    joint_limits = {}
    if limits:
        for g in GROUPS:
            joint_limits[f"{g}_hip_joint"] = (-0.5, 0.5)
            joint_limits[f"{g}_thigh_joint"] = (-0.5, 1.5)
            joint_limits[f"{g}_calf_joint"] = (-2.5, -1.0)
    offsets = {}
    if spring_offset:
        for g in GROUPS:
            offsets[f"{g}_hip_joint"] = 0.0
            offsets[f"{g}_thigh_joint"] = 0.9
            offsets[f"{g}_calf_joint"] = -1.425
    apply_zoo_options(
        joints,
        springs=None if parse_springs else springs,
        dampers=None if parse_dampers else dampers,
        joint_limits=joint_limits,
        rot_spring_offsets=offsets,
    )
    contacts = []
    if contact_feet:
        for g in GROUPS:
            contacts.append(
                bd.ContactDef(
                    body=f"{g}_calf", normal=Z, friction=friction_coefficient,
                    origin=[-0.006, 0, -0.092], radius=0.021,
                    name=f"{g}_calf_contact",
                )
            )
    if contact_body:
        for g in GROUPS:
            y = -0.023 if g in ("FR", "RR") else 0.023
            contacts.append(
                bd.ContactDef(
                    body=f"{g}_thigh", normal=Z, friction=friction_coefficient,
                    origin=[-0.005, y, -0.16], radius=0.023,
                    name=f"{g}_thigh_contact",
                )
            )
        for g in GROUPS:
            contacts.append(
                bd.ContactDef(
                    body=f"{g}_hip", normal=Z, friction=friction_coefficient,
                    origin=[0, 0.05, 0], radius=0.05, name=f"{g}_hip_contact",
                )
            )
    return bd.build(
        bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
        dtype=dtype, device=device,
    )


@register_init("quadruped")
def initialize_quadruped(
    mech, body_position=(0, 0, 0), body_orientation_rv=(0, 0, 0),
    hip_angle=0.0, thigh_angle=np.pi / 4, calf_angle=-np.pi / 2,
):
    s = mech.zero_state()
    y = maximal_to_minimal(mech.topo, mech.params, s).cpu().double().numpy().copy()
    slices, _ = _joint_slices(mech.topo)
    pos = np.asarray(body_position, dtype=np.float64) + [0, 0, 0.43]
    off, _, _ = slices[mech.joint_index["floating_base"]]
    y[off : off + 3] = pos
    y[off + 3 : off + 6] = body_orientation_rv
    for g in GROUPS:
        for nm, ang in (
            (f"{g}_hip_joint", hip_angle),
            (f"{g}_thigh_joint", thigh_angle),
            (f"{g}_calf_joint", calf_angle),
        ):
            off, _, _ = slices[mech.joint_index[nm]]
            y[off] = ang
    y = torch.as_tensor(y, dtype=mech.dtype, device=mech.device)
    return minimal_to_maximal(mech.topo, mech.params, y)
