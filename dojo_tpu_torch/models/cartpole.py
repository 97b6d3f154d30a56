"""Cartpole (counterpart of dojo_tpu/models/cartpole.py)."""

import numpy as np
import torch

from .. import builder as bd
from ..minimal import set_joint_minimal
from . import register, register_init

X, Y, Z = np.eye(3)


@register("cartpole")
def get_cartpole(
    timestep=0.01,
    gravity=-9.81,
    slider_mass=1.0,
    pendulum_mass=1.0,
    link_length=1.0,
    radius=0.075,
    springs=0.0,
    dampers=0.0,
    dtype=torch.float64,
    device=None,
):
    cart = bd.cylinder_body("cart", 1.5 * radius, 1.0, slider_mass)
    pole = bd.cylinder_body("pole", radius, link_length, pendulum_mass)
    joints = [
        bd.JointDef(kind="prismatic", parent="origin", child="cart", axis=Y,
                    spring=springs, damper=dampers, name="cart_joint"),
        bd.JointDef(kind="revolute", parent="cart", child="pole", axis=X,
                    child_vertex=-0.5 * link_length * Z,
                    spring=springs, damper=dampers, name="pole_joint"),
    ]
    return bd.build([cart, pole], joints, timestep=timestep, gravity=(0, 0, gravity),
                    dtype=dtype, device=device)


@register_init("cartpole")
def initialize_cartpole(mech, position=0.0, orientation=np.pi / 4):
    s = set_joint_minimal(mech.topo, mech.params, mech.zero_state(), 0, coords=[position])
    return set_joint_minimal(mech.topo, mech.params, s, 1, coords=[orientation])
