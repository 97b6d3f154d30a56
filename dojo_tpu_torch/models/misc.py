"""Humanoid from URDF (counterpart of the humanoid in
dojo_tpu/models/misc.py; that module's other models need fixed-joint
reduction, loop joints or other contact kinds, and are not ported yet)."""

import os

import numpy as np
import torch

from .. import builder as bd
from ..urdf import parse_urdf_defs
from . import register, register_init
from .locomotion import _init_from_y, _set_minimal, _shape

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
Z = np.array([0.0, 0.0, 1.0])


@register("humanoid")
def get_humanoid(timestep=0.01, gravity=-9.81, urdf="humanoid", parse_dampers=True,
                 friction_coefficient=0.8, contact_feet=True, dtype=torch.float64,
                 device=None):
    bodies, joints = parse_urdf_defs(os.path.join(ASSETS, f"{urdf}.urdf"), floating=True,
                                     parse_dampers=parse_dampers)
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
    def edit(y):
        _set_minimal(mech, y, "floating_base", list(body_position) + list(body_orientation_rv))

    return _init_from_y(mech, edit)
