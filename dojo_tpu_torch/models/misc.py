"""The remaining zoo mechanisms: raiberthopper, block2d, quadrotor, uuv,
panda, youbot, exoskeleton, humanoid, atlas and fourbar (counterpart of
dojo_tpu/models/misc.py).  The URDF models whose reference merges welded
bodies (``keep_fixed_joints=False``) run ``builder.reduce_fixed_joints`` on
the parsed definitions; fourbar closes a kinematic loop, so it has no
elimination schedule and its solver takes the dense path."""

import os

import numpy as np
import torch

from .. import builder as bd
from ..minimal import _joint_slices
from ..urdf import apply_zoo_options, parse_urdf_defs
from . import register, register_init
from .locomotion import _init_from_y, _set_minimal, _shape

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
X, _, Z = np.eye(3)
D2R = np.pi / 180


def _urdf(name, floating, parse_dampers):
    return parse_urdf_defs(os.path.join(ASSETS, f"{name}.urdf"), floating=floating,
                           parse_dampers=parse_dampers)


@register("raiberthopper")
def get_raiberthopper(timestep=0.05, gravity=-9.81, body_mass=4.18, foot_mass=0.52,
                      body_radius=0.1, foot_radius=0.05, dampers=(0.0, 0.1),
                      friction_coefficient=0.5, contact_foot=True, contact_body=True,
                      dtype=torch.float64, device=None):
    body = bd.sphere_body("body", body_radius, body_mass)
    foot = bd.sphere_body("foot", foot_radius, foot_mass)
    joints = [
        bd.JointDef(kind="floating", parent="origin", child="body", damper=dampers[0]),
        bd.JointDef(kind="prismatic", parent="body", child="foot", axis=Z, damper=dampers[1]),
    ]
    contacts = []
    if contact_foot:
        contacts.append(bd.ContactDef(body="foot", normal=Z, friction=friction_coefficient,
                                      radius=foot_radius, name="foot_contact"))
    if contact_body:
        contacts.append(bd.ContactDef(body="body", normal=Z, friction=friction_coefficient,
                                      radius=body_radius, name="body_contact"))
    return bd.build([body, foot], joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("raiberthopper")
def initialize_raiberthopper(mech, body_position=(0.0, 0.0, 0.0), leg_length=0.5):
    foot_radius = 0.05

    def edit(y):
        pos = np.asarray(body_position) + [0, 0, leg_length + foot_radius]
        _set_minimal(mech, y, "joint_0", list(pos) + [0, 0, 0])
        _set_minimal(mech, y, "joint_1", [-leg_length])

    return _init_from_y(mech, edit)


@register("block2d")
def get_block2d(timestep=0.01, gravity=-9.81, mass=1.0, edge_length=0.5,
                friction_coefficient=0.8, contact=True, contact_radius=0.0,
                contact_type="nonlinear", dtype=torch.float64, device=None):
    block = bd.box_body("block", edge_length, edge_length, edge_length, mass)
    joint = bd.JointDef(kind="planar_axis", parent="origin", child="block", axis=X, name="joint")
    e = edge_length / 2
    contacts = [
        bd.ContactDef(body="block", kind=contact_type, normal=Z, friction=friction_coefficient,
                      origin=o, radius=contact_radius, name=f"contact{i}")
        for i, o in enumerate(([0, e, e], [0, e, -e], [0, -e, e], [0, -e, -e]))
    ] if contact else []
    return bd.build([block], [joint], contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("block2d")
def initialize_block2d(mech, position=(0.0, 1.0), orientation=0.0, velocity=(0.0, 0.0),
                       angular_velocity=0.0):
    """The block's centre lifted by half its edge and the contact radius, so
    that position (0, 0) rests on the floor."""
    shape = mech.body_shapes[mech.body_index["block"]] or {}
    edge = (shape.get("xyz") or [0.5] * 3)[2] / 2
    radius = float(mech.params.contact_radius[0]) if mech.topo.nc else 0.0

    def edit(y):
        _set_minimal(mech, y, "joint", [position[0], position[1] + edge + radius, orientation])
        y[3:6] = [velocity[0], velocity[1], angular_velocity]

    return _init_from_y(mech, edit)


@register("quadrotor")
def get_quadrotor(timestep=0.01, gravity=-9.81, urdf="pelican_fixed_rotors", parse_dampers=True,
                  friction_coefficient=0.5, contact_rotors=True, contact_body=True,
                  keep_fixed_joints=False, dtype=torch.float64, device=None):
    """The Pelican quadrotor; keep_fixed_joints=False merges the four welded
    rotors into the base (one body instead of five)."""
    bodies, joints = _urdf(urdf, True, parse_dampers)
    contacts = []
    if contact_rotors:
        for i, o in enumerate(([0.21, 0, 0.045], [-0.21, 0, 0.045], [0, 0.21, 0.045],
                               [0, -0.21, 0.045])):
            contacts.append(bd.ContactDef(body="base_link", normal=Z,
                                          friction=friction_coefficient, origin=o, radius=0.07,
                                          name=f"rotor_contact{i}"))
    if contact_body:
        for i, o in enumerate(([0.11, 0, -0.085], [-0.11, 0, -0.085], [0, 0.11, -0.085],
                               [0, -0.11, -0.085])):
            contacts.append(bd.ContactDef(body="base_link", normal=Z,
                                          friction=friction_coefficient, origin=o,
                                          name=f"body_contact{i}"))
    if not keep_fixed_joints:
        bodies, joints, contacts = bd.reduce_fixed_joints(bodies, joints, contacts)
    return bd.build(bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


def _floating_base_at(mech, body_position, body_orientation_rv):
    def edit(y):
        _set_minimal(mech, y, "floating_base", list(body_position) + list(body_orientation_rv))

    return _init_from_y(mech, edit)


@register_init("quadrotor")
def initialize_quadrotor(mech, body_position=(0, 0, 0.23), body_orientation_rv=(0, 0, 0)):
    return _floating_base_at(mech, body_position, body_orientation_rv)


@register("uuv")
def get_uuv(timestep=0.01, gravity=0.0, urdf="mini_tortuga_fixed_rotors", parse_dampers=True,
            friction_coefficient=0.5, contact_body=True, keep_fixed_joints=False,
            dtype=torch.float64, device=None):
    """The Mini-Tortuga UUV; keep_fixed_joints=False merges the six welded
    thrusters into the hull.  Its URDF has an `origin` link and a floating
    joint of its own, so it is parsed without a floating base."""
    bodies, joints = _urdf(urdf, False, parse_dampers)
    contacts = [
        bd.ContactDef(body="base_link", normal=Z, friction=friction_coefficient, origin=o,
                      radius=0.21, name=f"hull_contact{i}")
        for i, o in enumerate(([0.12, 0, 0.07], [-0.12, 0, 0.07]))
    ] if contact_body else []
    if not keep_fixed_joints:
        bodies, joints, contacts = bd.reduce_fixed_joints(bodies, joints, contacts)
    return bd.build(bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("uuv")
def initialize_uuv(mech, body_position=(0, 0, 1.0), body_orientation_rv=(0, 0, 0)):
    return _floating_base_at(mech, body_position, body_orientation_rv)


def _arm(urdf, parse_dampers, limits, keep_fixed_joints, timestep, gravity, dtype, device,
         **options):
    """A fixed-base arm from URDF with the zoo's options and joint limits."""
    bodies, joints = _urdf(urdf, False, parse_dampers)
    apply_zoo_options(joints, joint_limits=limits, **options)
    if not keep_fixed_joints:
        bodies, joints, _ = bd.reduce_fixed_joints(bodies, joints, [])
    return bd.build(bodies, joints, [], timestep=timestep, gravity=(0, 0, gravity), dtype=dtype,
                    device=device)


@register("panda")
def get_panda(timestep=0.01, gravity=-9.81, urdf="panda_end_effector", springs=0.0, dampers=5.0,
              parse_springs=True, parse_dampers=False, limits=True, keep_fixed_joints=False,
              dtype=torch.float64, device=None):
    jl = {
        "joint1": (-2.8973, 2.8973), "joint2": (-1.7628, 1.7628),
        "joint3": (-2.8973, 2.8973), "joint4": (-3.0718, -0.0698),
        "joint5": (-2.8973, 2.8973), "joint6": (-0.0175, 3.7525),
        "joint7": (-2.8973, 2.8973), "jointf1": (0.0, 0.04),
        "jointf2": (0.0, 0.04),
    } if limits else {}
    return _arm(urdf, parse_dampers, jl, keep_fixed_joints, timestep, gravity, dtype, device,
                springs=None if parse_springs else springs,
                dampers=None if parse_dampers else dampers)


@register_init("panda")
def initialize_panda(mech, joint_angles=(0, 0.5, 0, -0.5, 0, 0.5, 0)):
    """The one-coordinate joints take ``joint_angles`` in joint order."""
    def edit(y):
        slices, _ = _joint_slices(mech.topo)
        angles = list(joint_angles)
        k = 0
        for j in range(mech.topo.nj):
            off, nt, nr = slices[j]
            if nt + nr == 1 and k < len(angles):
                y[off] = angles[k]
                k += 1

    return _init_from_y(mech, edit)


@register("youbot")
def get_youbot(timestep=0.01, gravity=-9.81, urdf="youbot", parse_dampers=True, limits=True,
               keep_fixed_joints=False, dtype=torch.float64, device=None):
    jl = {
        "arm_joint_1": (-2.95, 2.95), "arm_joint_2": (-1.57, 1.13),
        "arm_joint_3": (-2.55, 2.55), "arm_joint_4": (-1.78, 1.78),
        "arm_joint_5": (-2.92, 2.92),
    } if limits else {}
    return _arm(urdf, parse_dampers, jl, keep_fixed_joints, timestep, gravity, dtype, device)


@register_init("youbot")
def initialize_youbot(mech, body_position=(0.0, 0.0), body_orientation=0.0,
                      arm_angles=(0, 0, 0, 0, 0)):
    def edit(y):
        if "base_footprint_joint" in mech.joint_index:
            _set_minimal(mech, y, "base_footprint_joint",
                         [body_position[0], body_position[1], body_orientation])
        for i in range(5):
            if f"arm_joint_{i + 1}" in mech.joint_index:
                _set_minimal(mech, y, f"arm_joint_{i + 1}", [arm_angles[i]])

    return _init_from_y(mech, edit)


@register("exoskeleton")
def get_exoskeleton(timestep=0.01, gravity=-9.81, urdf="model", parse_dampers=True, limits=True,
                    keep_fixed_joints=False, dtype=torch.float64, device=None):
    jl = {
        "sAA": (0.0, 90 * D2R), "sFE": (0.0, 90 * D2R),
        "sIE": (-80 * D2R, 25 * D2R), "eFE": (-125 * D2R, 0.0),
    } if limits else {}
    return _arm(urdf, parse_dampers, jl, keep_fixed_joints, timestep, gravity, dtype, device)


@register_init("exoskeleton")
def initialize_exoskeleton(mech, joint_angles=(np.pi / 2, np.pi / 2 - 0.1, 0, -0.1)):
    def edit(y):
        for nm, a in zip(("sAA", "sFE", "sIE", "eFE"), joint_angles):
            if nm in mech.joint_index:
                _set_minimal(mech, y, nm, [a])

    return _init_from_y(mech, edit)


@register("humanoid")
def get_humanoid(timestep=0.01, gravity=-9.81, urdf="humanoid", parse_dampers=True,
                 friction_coefficient=0.8, contact_feet=True, dtype=torch.float64,
                 device=None):
    bodies, joints = _urdf(urdf, True, parse_dampers)
    contacts = []
    if contact_feet:
        for foot in ("left_foot", "right_foot"):
            sh = _shape(bodies, foot)
            r = sh["radius"] if sh and "radius" in sh else 0.05
            l = sh.get("length", 0.17) if sh else 0.17
            for sgn, tag in ((0.5, "toe"), (-0.5, "heel")):
                contacts.append(
                    bd.ContactDef(body=foot, normal=Z, friction=friction_coefficient,
                                  origin=[sgn * l, 0, 0], radius=r, name=f"{foot}_{tag}")
                )
    return bd.build(bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("humanoid")
def initialize_humanoid(mech, body_position=(0, 0, 1.33), body_orientation_rv=(0, 0, 0)):
    return _floating_base_at(mech, body_position, body_orientation_rv)


@register("atlas")
def get_atlas(timestep=0.01, gravity=-9.81, urdf="atlas_simple", springs=0.0, dampers=0.0,
              parse_springs=True, parse_dampers=True, friction_coefficient=0.8,
              contact_feet=True, keep_fixed_joints=False, dtype=torch.float64, device=None):
    """Atlas with four contact corners a foot; keep_fixed_joints=False merges
    the welded head into the upper torso."""
    bodies, joints = _urdf(urdf, True, parse_dampers)
    apply_zoo_options(joints, springs=None if parse_springs else springs,
                      dampers=None if parse_dampers else dampers)
    contacts = []
    if contact_feet:
        corners = ([-0.08, -0.04, 0.015], [0.12, -0.02, 0.015],
                   [-0.08, 0.04, 0.015], [0.12, 0.02, 0.015])
        for foot in ("l_foot", "r_foot"):
            for i, o in enumerate(corners):
                contacts.append(bd.ContactDef(body=foot, normal=Z, friction=friction_coefficient,
                                              origin=o, radius=0.025, name=f"{foot}_c{i}"))
    if not keep_fixed_joints:
        bodies, joints, contacts = bd.reduce_fixed_joints(bodies, joints, contacts)
    return bd.build(bodies, joints, contacts, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("atlas")
def initialize_atlas(mech, body_position=(0, 0, 0.9385), body_orientation_rv=(0, 0, 0)):
    return _floating_base_at(mech, body_position, body_orientation_rv)


@register("fourbar")
def get_fourbar(timestep=0.01, gravity=-9.81, urdf="fourbar", parse_dampers=True,
                dtype=torch.float64, device=None):
    """A four-bar linkage: a kinematic loop closed by a URDF loop joint."""
    bodies, joints = _urdf(urdf, False, parse_dampers)
    return bd.build(bodies, joints, [], timestep=timestep, gravity=(0, 0, gravity), dtype=dtype,
                    device=device)


@register_init("fourbar")
def initialize_fourbar(mech, base_angle=np.pi / 4, inner_angle=np.pi / 4):
    def edit(y):
        for nm, a in (("jointb1", base_angle + inner_angle),
                      ("jointb3", base_angle - inner_angle),
                      ("joint12", -2 * inner_angle),
                      ("joint34", 2 * inner_angle)):
            if nm in mech.joint_index:
                _set_minimal(mech, y, nm, [a])

    return _init_from_y(mech, edit)
