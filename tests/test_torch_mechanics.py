"""mechanics of the port against dojo_tpu.mechanics, float64 on the CPU.

The diagnostics are pure functions of (params, pre-step state, solution),
so both packages get the same numpy inputs: the port's own trajectory of a
sprung, damped pendulum (make_simulate, 20 steps, 3 lanes), and random
points of the quadruped under the trot controller's springs (every joint's
impulse, spring and damper terms).  Parameters go to the port through
convert.params_from_numpy.  dojo_tpu's functions run per lane, vmapped over
the steps.  Then the free-body conservation oracle of
tests/test_physics.py on the port alone.

Tolerances: momenta, velocities and energies within 1e-10 of the
reference (relative to max(1, |value|)); the oracle's own bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diff_step import port_mechanism

import dojo_tpu as jdt
from dojo_tpu import mechanics as jmech
from dojo_tpu import models as jmodels
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu_torch import mechanics, models
from dojo_tpu_torch.builder import Body, JointDef, build
from dojo_tpu_torch.core import BodyState, SolverOptions, tensor_map
from dojo_tpu_torch.mpc import trot_spring_params
from dojo_tpu_torch.residual import make_context
from dojo_tpu_torch.simulate import make_simulate
from dojo_tpu_torch.solver import make_solver

TOL = 1e-10
OPTS = SolverOptions(rtol=1e-10, btol=1e-10)
PENDULUM = dict(springs=2.0, dampers=0.3, spring_offset=(0.2,))
LANES = ((0.6, 1.3), (0.2, 0.0), (-0.5, -0.7))  # (angle, angular velocity)


def port_diagnostics(mech, state, w_sol, u=None):
    """(linear momenta, angular momenta, vl, ωl, kinetic, potential)."""
    ctx = make_context(mech.topo, state, mech.params, u)
    pl, pa = mechanics.momentum(mech.topo, mech.params, state, w_sol, ctx)
    vl, wl = mechanics.momentum_consistent_velocities(mech.params, state, pl, pa)
    return (pl, pa, vl, wl, mechanics.kinetic_energy(mech.params, vl, wl),
            mechanics.potential_energy(mech.topo, mech.params, state))


def reference_diagnostics(jm, params):
    """dojo_tpu's diagnostics of one lane, vmapped over points, jitted."""
    def one(x, q, v, w, wsol, u):
        st = jdt.BodyState(x=x, q=q, v=v, w=w)
        ctx = j_make_context(jm.topo, st, params, u)
        pl, pa = jmech.momentum(jm.topo, params, st, wsol, ctx)
        vl, wl = jmech.momentum_consistent_velocities(params, st, pl, pa)
        return (pl, pa, vl, wl, jmech.kinetic_energy(params, vl, wl),
                jmech.potential_energy(jm.topo, params, st))

    return jax.jit(jax.vmap(one))


def assert_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err < TOL, f"{what}: {err}"


NAMES = ("p_linear", "p_angular", "vl", "wl", "kinetic", "potential")


@pytest.fixture(scope="module")
def pendulum():
    """The port's 20-step trajectory and its diagnostics, time-major."""
    jm = jmodels.get_mechanism("pendulum", **PENDULUM)
    mech = port_mechanism(jm, "pendulum", **PENDULUM)
    s0 = [models.initialize(mech, "pendulum", angle=a, angular_velocity=av)
          for a, av in LANES]
    s0 = BodyState(*(torch.stack([getattr(s, f) for s in s0]) for f in "xqvw"))
    _, traj = make_simulate(mech.topo, OPTS, device="cpu")(mech.params, s0, horizon=20)
    state = BodyState(traj.x, traj.q, traj.v, traj.w)
    return jm, mech, traj, port_diagnostics(mech, state, traj.info.w)


def test_pendulum_trajectory_matches_reference(pendulum):
    jm, _, traj, got = pendulum
    assert bool(traj.info.success.all())
    ref_fn = reference_diagnostics(jm, jm.params)
    u0 = jnp.zeros((traj.x.shape[0], jm.topo.nj, 6))
    for b in range(len(LANES)):
        args = [jnp.asarray(getattr(traj, f)[:, b].numpy()) for f in "xqvw"]
        ref = ref_fn(*args, jnp.asarray(traj.info.w[:, b].numpy()), u0)
        for name, g, r in zip(NAMES, got, ref):
            assert_close(g[:, b], r, f"lane {b} {name}")


def test_pendulum_energy_is_bounded(pendulum):
    """The sprung, damped pendulum's mechanical energy never rises (the
    damper only takes energy out) beyond the integrator's oscillation."""
    *_, (_, _, _, _, ke, pe) = pendulum
    me = (ke + pe).numpy()
    assert (me[1:] - me[:1] < 1e-3).all(), me


def test_quadruped_points_match_reference():
    """Random points of the quadruped under the trot springs and dampers:
    states near standing, solutions near the cone-neutral init, inputs."""
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    mech = port_mechanism(jm, "quadruped", timestep=0.05)
    mech.params = trot_spring_params(mech, 40.0, 4.0)
    jp = jm.params._replace(**{f: jnp.asarray(getattr(mech.params, f).numpy())
                               for f in jm.params._fields})
    rng = np.random.default_rng(5)
    s0 = models.initialize(mech, "quadruped")
    n = 3
    state = tensor_map(lambda a: a.expand(n, *a.shape).clone(), s0)
    state.x += torch.as_tensor(rng.normal(scale=0.01, size=state.x.shape))
    state.v += torch.as_tensor(rng.normal(scale=0.1, size=state.v.shape))
    state.w += torch.as_tensor(rng.normal(scale=0.1, size=state.w.shape))
    w0 = make_solver(mech.topo, device="cpu")[0](state.v, state.w, mech.params)
    w_sol = w0 + torch.as_tensor(rng.normal(scale=0.05, size=w0.shape))
    u = torch.as_tensor(rng.normal(scale=0.5, size=(n, mech.topo.nj, 6)))
    got = port_diagnostics(mech, state, w_sol, u)
    ref = reference_diagnostics(jm, jp)(
        *(jnp.asarray(getattr(state, f).numpy()) for f in "xqvw"),
        jnp.asarray(w_sol.numpy()), jnp.asarray(u.numpy()))
    for name, g, r in zip(NAMES, got, ref):
        assert_close(g, r, name)


def test_free_body_conservation():
    """A torque-free tumbling body (tests/test_physics.py's oracle) on the
    port: energy and both momenta conserved, unit quaternions, on 3 lanes
    of different spin."""
    b = Body("brick", 1.0, np.diag([1.9, 2.1, 3.2]))
    j = JointDef(kind="floating", parent="origin", child="brick")
    mech = build([b], [j], timestep=0.01, gravity=(0, 0, 0), device="cpu")
    s0 = mech.zero_state()
    spins = torch.tensor([[[0.2, 3.0, 0.01]], [[1.5, 0.1, -0.4]], [[0.0, -2.0, 2.0]]],
                         dtype=torch.float64)
    state = dataclasses.replace(
        tensor_map(lambda a: a.expand(3, *a.shape).clone(), s0), w=spins,
        v=torch.tensor([[0.3, -0.2, 0.1]], dtype=torch.float64).expand(3, 1, 3).clone())
    _, traj = make_simulate(mech.topo, SolverOptions(rtol=1e-9, btol=1e-9), device="cpu")(
        mech.params, state, horizon=15)
    assert bool(traj.info.success.all())
    pl, pa, _, _, ke, pe = port_diagnostics(mech, BodyState(traj.x, traj.q, traj.v, traj.w),
                                            traj.info.w)
    me, pl, pa = ke + pe, pl.sum(-2), pa.sum(-2)  # one body: no orbital term
    assert float((me - me[0]).abs().max()) < 1e-6
    assert float((pl - pl[0]).abs().max()) < 1e-10
    assert float((pa - pa[0]).abs().max()) < 1e-6
    assert float((traj.q.norm(dim=-1) - 1).abs().max()) < 1e-12
