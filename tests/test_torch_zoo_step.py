"""One float64 zoo step of the port against dojo_tpu's, lane by lane, for
the pendulum; check_step serves tests/test_torch_zoo_step_*.py too, one
file per model so that their XLA compiles run in parallel (cartpole, and
snake and block, one model of each new width class of the kernels; the
other seven models are in test_torch_zoo_step_slow.py).

Two lanes per model, built by the port and handed to both packages as
numpy: the model's initial state and a second one from other initializer
arguments (in contact where the model has contacts).  One cold step with
bench_zoo.py's options (rtol=1e-6, btol=1e-4, max_iter=30, u=None): success
and iterations equal, w and the next state within 1e-8; success on every
lane except the sphere's (FAIL_F64), which fails in both packages.  dojo_tpu's solve
closure is wrapped in jax.jit, as tests/test_torch_step.py does it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dojo_tpu.simulate as jsim
from dojo_tpu import models as jmodels
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu_torch import models
from dojo_tpu_torch.core import BodyState, SolverOptions
from dojo_tpu_torch.simulate import make_step

OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)
FIELDS = ("x", "q", "v", "w")
# w and the next state agree to 1e-8, except atlas's (a 436-dim KKT with
# joint springs): its two solves, each within rtol = 1e-6, part by up to
# 3.8e-8 in w (12 of 872 entries) after the same 8 iterations; held to
# rtol's 1e-6
ATOL = {"atlas": 1e-6}
# the sphere rolls at 1 m/s on the ground: in float64 neither package brings
# its cone violation under btol within max_iter, on either lane
FAIL_F64 = {"sphere"}
# initializer arguments of each model's second lane
SECOND_LANE = {
    "pendulum": {"angle": 0.3, "angular_velocity": 1.0},
    "npendulum": {"base_angle": 0.2},
    "cartpole": {"position": 0.2, "orientation": 0.5},
    "block": {"position": (0, 0, 0.249), "velocity": (0.3, 0, 0)},
    "sphere": {"position": (0, 0, 0.499)},
    "snake": {"base_position": (0, 0, -0.001)},
    "hopper": {"body_position": (0, -0.01)},
    "halfcheetah": {"body_position": (-0.01, 0.0)},
    "walker": {"body_position": (0.0, -0.01)},
    "ant": {"body_position": (0, 0, 0.6)},
    "humanoid": {"body_position": (0, 0, 1.3)},
    "dzhanibekov": {"angular_velocity": (0.5, 2.0, 0.1)},
    "tippetop": {"angular_velocity": (0.0, 0.01, 30.0)},
    "raiberthopper": {"body_position": (0, 0, -0.001)},
    "block2d": {"position": (0.0, 0.0), "velocity": (0.3, 0.0)},
    "quadrotor": {"body_position": (0, 0, 0.22)},
    "uuv": {"body_position": (0, 0, 0.5)},
    "panda": {"joint_angles": (0.1, 0.4, 0.0, -0.6, 0.0, 0.6, 0.1)},
    "youbot": {"arm_angles": (0.1, 0.2, -0.2, 0.1, 0.0)},
    "exoskeleton": {"joint_angles": (1.4, 1.3, 0.1, -0.3)},
    "atlas": {"body_position": (0, 0, 0.9385)},
    "fourbar": {"inner_angle": 0.25},
}


def initial(name):
    """Both lanes' initial states as numpy, (2, nb, k) per field."""
    mech = models.get_mechanism(name, device="cpu")
    lanes = [models.initialize(mech, name), models.initialize(mech, name, **SECOND_LANE[name])]
    return {f: np.stack([getattr(s, f).numpy() for s in lanes]) for f in FIELDS}


def reference_step(name, init):
    jm = jmodels.get_mechanism(name)
    make_solver = jsim.make_solver

    def make_solver_jit(topo, linsolve="auto"):
        init_w, solve, violations = make_solver(topo, linsolve=linsolve)
        return init_w, jax.jit(solve, static_argnums=3), violations

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "make_solver", make_solver_jit)
        step = jsim.make_step(jm.topo, JOpts(**OPTS))
    s = type(jm.zero_state())(**{f: jnp.asarray(a) for f, a in init.items()})
    s2, info = jax.vmap(lambda st: step(jm.params, st, None))(s)
    return ({f: np.asarray(getattr(s2, f)) for f in FIELDS},
            {f: np.asarray(getattr(info, f)) for f in ("success", "iterations", "w")})


def port_step(name, init):
    mech = models.get_mechanism(name, device="cpu")
    step = make_step(mech.topo, SolverOptions(**OPTS), device="cpu")
    s = BodyState(**{f: torch.as_tensor(a) for f, a in init.items()})
    return step(mech.params, s)


def check_step(name):
    init = initial(name)
    ref_state, ref_info = reference_step(name, init)
    s, info = port_step(name, init)
    np.testing.assert_array_equal(info.success.numpy(), ref_info["success"])
    assert bool(info.success.all()) == (name not in FAIL_F64)
    np.testing.assert_array_equal(info.iterations.numpy(), ref_info["iterations"])
    atol = ATOL.get(name, 1e-8)
    np.testing.assert_allclose(info.w.numpy(), ref_info["w"], rtol=0, atol=atol)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(s, f).numpy(), ref_state[f], rtol=0, atol=atol,
                                   err_msg=f)
    assert not info.rescued.any()
    return info


def test_pendulum_step_matches_reference():
    check_step("pendulum")
