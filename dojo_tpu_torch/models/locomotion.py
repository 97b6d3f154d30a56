"""Planar and 3D locomotion robots from URDF: hopper, halfcheetah, walker,
ant (counterpart of dojo_tpu/models/locomotion.py)."""

import os

import numpy as np
import torch

from .. import builder as bd
from ..minimal import _joint_slices, maximal_to_minimal, minimal_to_maximal
from ..urdf import apply_zoo_options, parse_urdf_defs
from . import register, register_init

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
Z = np.array([0.0, 0.0, 1.0])
D2R = np.pi / 180


def _shape(bodies, name):
    """The shape of the body called ``name``, or None."""
    for b in bodies:
        if b.name == name:
            return b.shape
    return None


def _set_minimal(mech, state_y, name, values):
    """Write ``values`` at the start of joint ``name``'s minimal slice."""
    off, _, _ = _joint_slices(mech.topo)[0][mech.joint_index[name]]
    state_y[off : off + len(values)] = values
    return state_y


def _init_from_y(mech, edit):
    """The zero state's minimal vector, changed in place by ``edit`` (numpy,
    float64), mapped back to maximal coordinates."""
    s = mech.zero_state()
    y = maximal_to_minimal(mech.topo, mech.params, s).cpu().double().numpy().copy()
    edit(y)
    y = torch.as_tensor(y, dtype=mech.dtype, device=mech.device)
    return minimal_to_maximal(mech.topo, mech.params, y)


@register("hopper")
def get_hopper(
    timestep=0.01, gravity=-9.81, urdf="hopper", springs=10.0, dampers=0.0,
    parse_springs=True, parse_dampers=True, limits=True,
    friction_coefficient=2.0, contact_foot=True, contact_body=True,
    dtype=torch.float64, device=None,
):
    bodies, joints = parse_urdf_defs(
        os.path.join(ASSETS, f"{urdf}.urdf"), floating=False,
        parse_dampers=parse_dampers,
    )
    jl = {}
    if limits:
        jl = {
            "thigh": (0.0, 150 * D2R),
            "leg": (0.0, 150 * D2R),
            "foot": (-45 * D2R, 45 * D2R),
        }
    apply_zoo_options(
        joints,
        springs=None if parse_springs else springs,
        dampers=None if parse_dampers else dampers,
        joint_limits=jl,
    )
    contacts = []
    foot = _shape(bodies, "foot")
    if contact_foot and foot:
        r, l = foot["radius"], foot["length"]
        contacts += [
            bd.ContactDef(body="foot", normal=Z, friction=friction_coefficient,
                          origin=[0, 0, 0.5 * l], radius=r, name="foot_heel"),
            bd.ContactDef(body="foot", normal=Z, friction=friction_coefficient,
                          origin=[0, 0, -0.5 * l], radius=r, name="foot_toe"),
        ]
    if contact_body:
        for b in bodies:
            if b.name == "foot" or not b.shape or "radius" not in b.shape:
                continue
            r = b.shape["radius"]
            l = b.shape.get("length", 0.0)
            contacts.append(
                bd.ContactDef(body=b.name, normal=Z, friction=friction_coefficient,
                              origin=[0, 0, 0.5 * l], radius=r,
                              name=f"{b.name}_contact")
            )
    return bd.build(bodies, joints, contacts, timestep=timestep,
                    gravity=(0, 0, gravity), dtype=dtype, device=device)


@register_init("hopper")
def initialize_hopper(mech, body_position=(0, 0), body_orientation=0.0):
    def edit(y):
        _set_minimal(
            mech, y, "floating_joint",
            [body_position[0] + 1.25, body_position[1], body_orientation],
        )

    return _init_from_y(mech, edit)


@register("halfcheetah")
def get_halfcheetah(
    timestep=0.01, gravity=-9.81, urdf="halfcheetah", springs=0.0, dampers=0.0,
    parse_springs=True, parse_dampers=True, limits=True,
    friction_coefficient=0.4, contact_feet=True, contact_body=True,
    dtype=torch.float64, device=None,
):
    bodies, joints = parse_urdf_defs(
        os.path.join(ASSETS, f"{urdf}.urdf"), floating=False,
        parse_dampers=parse_dampers,
    )
    jl = {}
    if limits:
        jl = {
            "bthigh": (-0.52, 1.05), "bshin": (-0.785, 0.785),
            "bfoot": (-0.4, 0.785), "fthigh": (-1.0, 0.7),
            "fshin": (-1.2, 0.87), "ffoot": (-0.5, 0.5),
        }
    apply_zoo_options(
        joints,
        springs=None if parse_springs else springs,
        dampers=None if parse_dampers else dampers,
        joint_limits=jl,
    )
    contacts = []
    if contact_feet:
        for nm in ("ffoot", "bfoot"):
            sh = _shape(bodies, nm)
            if sh and "radius" in sh:
                contacts.append(
                    bd.ContactDef(body=nm, normal=Z, friction=friction_coefficient,
                                  origin=[0, 0, -0.5 * sh["length"]],
                                  radius=sh["radius"], name=f"{nm}_contact")
                )
    if contact_body:
        torso = _shape(bodies, "torso")
        if torso and "radius" in torso:
            r, l = torso["radius"], torso["length"]
            contacts += [
                bd.ContactDef(body="torso", normal=Z, friction=friction_coefficient,
                              origin=[0.5 * l, 0, 0], radius=r, name="torso_front"),
                bd.ContactDef(body="torso", normal=Z, friction=friction_coefficient,
                              origin=[-0.5 * l, 0, 0], radius=r, name="torso_back"),
                bd.ContactDef(body="torso", normal=Z, friction=friction_coefficient,
                              origin=[0.5 * l + 0.214, 0, 0.1935], radius=r,
                              name="torso_head"),
            ]
        for b in bodies:
            if b.name in ("ffoot", "bfoot", "torso") or not b.shape:
                continue
            if "radius" not in b.shape:
                continue
            contacts.append(
                bd.ContactDef(body=b.name, normal=Z, friction=friction_coefficient,
                              origin=[0, 0, -0.5 * b.shape.get("length", 0.0)],
                              radius=b.shape["radius"], name=f"{b.name}_contact")
            )
    return bd.build(bodies, joints, contacts, timestep=timestep,
                    gravity=(0, 0, gravity), dtype=dtype, device=device)


@register_init("halfcheetah")
def initialize_halfcheetah(mech, body_position=(0.0, 0.0), body_orientation=0.0):
    # planaraxis (axis Y) nullspace basis rows are (+Z, −X), so the HEIGHT
    # goes in the FIRST minimal slot (reference halfcheetah/mechanism.jl:97-98,
    # incl. the 0.02792 rad torso pitch of the rest pose)
    def edit(y):
        _set_minimal(
            mech, y, "floating_joint",
            [body_position[0] + 0.576509, body_position[1],
             body_orientation + 0.02792],
        )

    return _init_from_y(mech, edit)


@register("walker")
def get_walker(
    timestep=0.01, gravity=-9.81, urdf="walker", springs=0.0, dampers=0.0,
    parse_springs=True, parse_dampers=True, limits=True,
    friction_coefficient=0.5, contact_feet=True, contact_body=True,
    dtype=torch.float64, device=None,
):
    bodies, joints = parse_urdf_defs(
        os.path.join(ASSETS, f"{urdf}.urdf"), floating=False,
        parse_dampers=parse_dampers,
    )
    jl = {}
    if limits:
        for nm in ("thigh", "leg", "foot", "thigh_left", "leg_left", "foot_left"):
            lim = (0.0, 150 * D2R) if "thigh" in nm or "leg" in nm else (-45 * D2R, 45 * D2R)
            jl[nm] = lim
    apply_zoo_options(
        joints,
        springs=None if parse_springs else springs,
        dampers=None if parse_dampers else dampers,
        joint_limits=jl,
    )
    contacts = []
    if contact_feet:
        for nm in ("foot", "foot_left"):
            sh = _shape(bodies, nm)
            if sh and "radius" in sh:
                r, l = sh["radius"], sh["length"]
                contacts += [
                    bd.ContactDef(body=nm, normal=Z, friction=friction_coefficient,
                                  origin=[0, 0, 0.5 * l], radius=r,
                                  name=f"{nm}_heel"),
                    bd.ContactDef(body=nm, normal=Z, friction=friction_coefficient,
                                  origin=[0, 0, -0.5 * l], radius=r,
                                  name=f"{nm}_toe"),
                ]
    if contact_body:
        for b in bodies:
            if "foot" in b.name or not b.shape or "radius" not in b.shape:
                continue
            contacts.append(
                bd.ContactDef(body=b.name, normal=Z, friction=friction_coefficient,
                              origin=[0, 0, 0.5 * b.shape.get("length", 0.0)],
                              radius=b.shape["radius"], name=f"{b.name}_contact")
            )
    return bd.build(bodies, joints, contacts, timestep=timestep,
                    gravity=(0, 0, gravity), dtype=dtype, device=device)


@register_init("walker")
def initialize_walker(mech, body_position=(0.0, 0.0), body_orientation=0.0):
    # height in the FIRST planar slot (see halfcheetah note;
    # reference walker/mechanism.jl:90-91)
    def edit(y):
        _set_minimal(
            mech, y, "floating_joint",
            [body_position[0] + 1.25, body_position[1], body_orientation],
        )

    return _init_from_y(mech, edit)


@register("ant")
def get_ant(
    timestep=0.05, gravity=-9.81, urdf="ant", springs=0.0, dampers=0.0,
    parse_springs=True, parse_dampers=True, limits=True,
    friction_coefficient=0.5, contact_feet=True, contact_body=True,
    dtype=torch.float64, device=None,
):
    bodies, joints = parse_urdf_defs(
        os.path.join(ASSETS, f"{urdf}.urdf"), floating=True,
        parse_dampers=parse_dampers,
    )
    jl = {}
    if limits:
        jl = {
            "hip_1": (-30 * D2R, 30 * D2R), "ankle_1": (30 * D2R, 70 * D2R),
            "hip_2": (-30 * D2R, 30 * D2R), "ankle_2": (-70 * D2R, -30 * D2R),
            "hip_3": (-30 * D2R, 30 * D2R), "ankle_3": (-70 * D2R, -30 * D2R),
            "hip_4": (-30 * D2R, 30 * D2R), "ankle_4": (30 * D2R, 70 * D2R),
        }
    apply_zoo_options(
        joints,
        springs=None if parse_springs else springs,
        dampers=None if parse_dampers else dampers,
        joint_limits=jl,
    )
    contacts = []
    feet = [
        ("front_left_foot", [0.2, 0.2, 0]), ("front_right_foot", [-0.2, 0.2, 0]),
        ("left_back_foot", [-0.2, -0.2, 0]), ("right_back_foot", [0.2, -0.2, 0]),
    ]
    if contact_feet:
        for nm, orig in feet:
            sh = _shape(bodies, nm)
            r = sh["radius"] if sh and "radius" in sh else 0.08
            contacts.append(
                bd.ContactDef(body=nm, normal=Z, friction=friction_coefficient,
                              origin=orig, radius=r, name=f"{nm}_contact")
            )
    if contact_body:
        torso = _shape(bodies, "torso")
        r = torso["radius"] if torso and "radius" in torso else 0.25
        contacts.append(
            bd.ContactDef(body="torso", normal=Z, friction=friction_coefficient,
                          radius=r, name="torso_contact")
        )
        elbows = [
            ("aux_1", [-0.1, -0.1, 0]), ("aux_2", [0.1, -0.1, 0]),
            ("aux_3", [0.1, 0.1, 0]), ("aux_4", [-0.1, 0.1, 0]),
        ]
        for nm, orig in elbows:
            sh = _shape(bodies, nm)
            r = sh["radius"] if sh and "radius" in sh else 0.08
            contacts.append(
                bd.ContactDef(body=nm, normal=Z, friction=friction_coefficient,
                              origin=orig, radius=r, name=f"{nm}_contact")
            )
    return bd.build(bodies, joints, contacts, timestep=timestep,
                    gravity=(0, 0, gravity), dtype=dtype, device=device)


@register_init("ant")
def initialize_ant(mech, body_position=(0, 0, 0.63), ankle_angle=0.25):
    def edit(y):
        _set_minimal(mech, y, "floating_base",
                     list(body_position) + [0.0, 0.0, 0.0])
        for i in (1, 2, 3, 4):
            sgn = 1.0 if i in (1, 4) else -1.0
            try:
                _set_minimal(mech, y, f"ankle_{i}", [sgn * ankle_angle])
            except KeyError:
                pass

    return _init_from_y(mech, edit)
