"""dojo_tpu_torch — the PyTorch/CUDA port of dojo_tpu.

Differentiable maximal-coordinate contact physics with a Mehrotra
interior-point solver over a graph-sparse block LDU, whose three kernels
(factorize, solve, matvec) are hand-written CUDA for Hopper (csrc/ldu.cu),
and implicit-function-theorem gradients through contact.
Imports torch and numpy only — never JAX, never dojo_tpu.  Entry points run
on CUDA unless given ``device="cpu"``.

    from dojo_tpu_torch import models
    from dojo_tpu_torch.core import SolverOptions
    from dojo_tpu_torch.simulate import make_step
    mech = models.get_mechanism("quadruped", timestep=0.05)
    state = models.initialize(mech, "quadruped")
    step = make_step(mech.topo, SolverOptions())
"""

from . import lie, mechanics, minimal, models, mpc, urdf
from .builder import (
    Body,
    ContactDef,
    JointDef,
    Mechanism,
    box_body,
    build,
    capsule_body,
    combined_body,
    cylinder_body,
    mesh_body,
    pyramid_body,
    reduce_fixed_joints,
    set_floating_base,
    sphere_body,
)
from .contacts import signed_distances
from .core import REG, BodyState, Params, SolverOptions, Topology
from .gradients import (
    attitude_jacobian,
    finite_difference_jacobian,
    make_diff_step,
    make_diff_step_minimal,
    make_rollout_linearize_minimal,
    maximal_jacobians,
    maximal_jacobians_attjac,
    minimal_jacobians,
)
from .residual import make_context, make_residual, pad_inputs
from .simulate import StepInfo, Trajectory, make_simulate, make_step
from .solver import SolveResult, make_solver
