"""Pendulum family: pendulum, npendulum, slider, nslider (counterpart of
dojo_tpu/models/pendulum.py)."""

import numpy as np
import torch

from .. import builder as bd
from ..minimal import set_joint_minimal
from . import register, register_init

X, Y, Z = np.eye(3)


@register("pendulum")
def get_pendulum(
    timestep=0.01,
    gravity=-9.81,
    mass=1.0,
    link_length=1.0,
    springs=0.0,
    dampers=0.0,
    spring_offset=(0.0,),
    orientation_offset=(1.0, 0, 0, 0),
    rot_limits=None,
    dtype=torch.float64,
    device=None,
):
    body = bd.box_body("pendulum", 0.1, 0.1, link_length, mass)
    joint = bd.JointDef(
        kind="revolute",
        parent="origin",
        child="pendulum",
        axis=X,
        parent_vertex=(link_length + 0.1) * Z,
        child_vertex=0.5 * link_length * Z,
        orientation_offset=orientation_offset,
        spring=springs,
        damper=dampers,
        rot_spring_offset=spring_offset,
        rot_limits=rot_limits,
        name="joint",
    )
    return bd.build([body], [joint], timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("pendulum")
def initialize_pendulum(mech, angle=np.pi / 4, angular_velocity=0.0):
    return set_joint_minimal(mech.topo, mech.params, mech.zero_state(), 0, coords=[angle],
                             velocities=[angular_velocity])


@register("npendulum")
def get_npendulum(
    timestep=0.01,
    gravity=-9.81,
    num_bodies=5,
    mass=1.0,
    link_length=1.0,
    springs=0.0,
    dampers=0.0,
    base_joint_type="revolute",
    rest_joint_type="revolute",
    dtype=torch.float64,
    device=None,
):
    bodies = [bd.box_body(f"link{i}", 0.05, 0.05, link_length, mass) for i in range(num_bodies)]
    joints = [
        bd.JointDef(
            kind=base_joint_type,
            parent="origin",
            child="link0",
            axis=X,
            parent_vertex=(link_length + 0.1) * num_bodies * Z,
            child_vertex=0.5 * link_length * Z,
            spring=springs,
            damper=dampers,
        )
    ]
    for i in range(1, num_bodies):
        joints.append(
            bd.JointDef(
                kind=rest_joint_type,
                parent=f"link{i-1}",
                child=f"link{i}",
                axis=X,
                parent_vertex=-0.5 * link_length * Z,
                child_vertex=0.5 * link_length * Z,
                spring=springs,
                damper=dampers,
            )
        )
    return bd.build(bodies, joints, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("npendulum")
def initialize_npendulum(mech, base_angle=np.pi / 4):
    return set_joint_minimal(mech.topo, mech.params, mech.zero_state(), 0, coords=[base_angle])


@register("slider")
def get_slider(timestep=0.01, gravity=-9.81, mass=1.0, link_length=1.0, springs=0.0,
               dampers=0.0, dtype=torch.float64, device=None):
    body = bd.box_body("slider", 0.1, 0.1, link_length, mass)
    joint = bd.JointDef(
        kind="prismatic",
        parent="origin",
        child="slider",
        axis=Z,
        child_vertex=0.5 * link_length * Z,
        spring=springs,
        damper=dampers,
        name="joint",
    )
    return bd.build([body], [joint], timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("slider")
def initialize_slider(mech, position=0.0, velocity=0.0):
    return set_joint_minimal(mech.topo, mech.params, mech.zero_state(), 0, coords=[position],
                             velocities=[velocity])


@register("nslider")
def get_nslider(timestep=0.01, gravity=-9.81, num_bodies=5, mass=1.0, link_length=1.0,
                springs=0.0, dampers=0.0, dtype=torch.float64, device=None):
    bodies = [bd.box_body(f"link{i}", 0.05, 0.05, link_length, mass) for i in range(num_bodies)]
    joints = [
        bd.JointDef(kind="prismatic", parent="origin", child="link0", axis=Z,
                    spring=springs, damper=dampers)
    ]
    for i in range(1, num_bodies):
        joints.append(
            bd.JointDef(
                kind="prismatic",
                parent=f"link{i-1}",
                child=f"link{i}",
                axis=Z,
                parent_vertex=0.25 * link_length * Z,
                spring=springs,
                damper=dampers,
            )
        )
    return bd.build(bodies, joints, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)
