"""solve.traced and make_simulate / Trajectory of the port against dojo_tpu,
float64 on the CPU.

Three lanes in the port, each compared with dojo_tpu on that lane, on the
same numpy inputs (parameters through convert.params_from_numpy).
dojo_tpu's solve (static options) and make_context are jitted and its
make_step runs around them, as tests/test_torch_zoo_step.py does; the
rollout reference steps it as dojo_tpu's make_simulate scans it (cold: no
w_prev; warm: the cone-neutral init of the first state, then each step's
solution), recording the pre-step state, so that one solver compile
serves both.  Tier-1 holds the pendulum's rollouts and solve.traced to
dojo_tpu's, make_simulate to make_step stepped by hand, solve.traced to
solve, and the Mechanism surface to dojo_tpu's; the cartpole's rollouts
and dojo_tpu's jitted make_simulate (a scan of the whole rollout), whose
compiles take minutes, are marked slow and run by hand.

Tolerances: w within 1e-12 of its scale (max(1, |w|)) for the solve, the
states within 1e-10 and each StepInfo field within 1e-10 of its scale for
the rollouts; success, iterations and the trace's valid flags equal; the
trace's rvio, bvio and μ within 1e-12 plus 1e-6 relative, undercut equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diff_step import port_mechanism

import dojo_tpu.simulate as jsim
from dojo_tpu import models as jmodels
from dojo_tpu.core import BodyState as JState
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import pad_inputs as j_pad_inputs
from dojo_tpu.solver import make_solver as j_make_solver
from dojo_tpu_torch import models
from dojo_tpu_torch.core import BodyState, SolverOptions
from dojo_tpu_torch.residual import make_context, pad_inputs
from dojo_tpu_torch.simulate import make_simulate, make_step
from dojo_tpu_torch.solver import make_solver

OPTS = dict(rtol=1e-10, btol=1e-10)
T = 20
FIELDS = "xqvw"
INFO = ("success", "iterations", "rvio", "bvio", "w", "rescued")
LANES = {  # initializer arguments of each model's three lanes
    "pendulum": [dict(angle=0.6, angular_velocity=1.3), dict(angle=0.2),
                 dict(angle=-1.0, angular_velocity=-0.4)],
    "cartpole": [dict(position=0.0, orientation=0.3), dict(position=0.2, orientation=-0.5),
                 dict(position=-0.1, orientation=1.0)],
}
MODELS = ["pendulum", pytest.param("cartpole", marks=pytest.mark.slow)]
# the cartpole's second input coordinate is its pole joint's: inputs on both
U = {"pendulum": [0.4], "cartpole": [1.5, -0.2]}


def lanes(mech, name):
    states = [models.initialize(mech, name, **kw) for kw in LANES[name]]
    return BodyState(*(torch.stack([getattr(s, f) for s in states]) for f in FIELDS))


def jitted_solver_step(jm, opts):
    """dojo_tpu's make_step with its solve (static options) and its
    make_context jitted: the rest runs op by op."""
    def make_solver_jit(topo, linsolve="auto"):
        init_w, solve, violations = j_make_solver(topo, linsolve=linsolve)
        return init_w, jax.jit(solve, static_argnums=3), violations

    context = jax.jit(jsim.make_context, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "make_solver", make_solver_jit)
        step = jsim.make_step(jm.topo, opts)

    def jitted(*args, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jsim, "make_context", context)
            return step(*args, **kw)

    jitted.init_w = step.init_w
    return jitted


def reference_rollout(step, params, state, us, warm):
    """dojo_tpu's make_simulate body, step by step on one lane: (pre-step
    states, StepInfo fields), each stacked over the steps, numpy."""
    w_prev = step.init_w(state.v, state.w, params) if warm else None
    pre, infos = [], []
    for u in us:
        pre.append(state)
        state, info = step(params, state, u, w_prev=w_prev)
        if warm:
            w_prev = info.w
        infos.append(info)
    stack = lambda objs, f: np.stack([np.asarray(getattr(o, f)) for o in objs])
    return ({f: stack(pre, f) for f in FIELDS}, {f: stack(infos, f) for f in INFO})


def close(got, ref, tol, what):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err < tol, f"{what}: {err}"


@pytest.fixture(scope="module", params=MODELS)
def rollouts(request):
    """Each model's port and reference rollouts, cold and warm, with a
    per-step input on every lane (the same input, padded, in both)."""
    name = request.param
    jm = jmodels.get_mechanism(name)
    mech = port_mechanism(jm, name)
    state = lanes(mech, name)
    u = torch.as_tensor(np.array(U[name]))
    us = pad_inputs(mech.topo, u).expand(T, 3, mech.topo.nj, 6)
    sim = make_simulate(mech.topo, SolverOptions(**OPTS), device="cpu")
    step = jitted_solver_step(jm, JOpts(**OPTS))
    ju = jnp.broadcast_to(j_pad_inputs(jm.topo, jnp.asarray(U[name])), (T, jm.topo.nj, 6))
    out = {}
    for warm in (False, True):
        final, traj = sim(mech.params, state, us, warm_start=warm)
        refs = []
        for b in range(3):
            s = JState(*(jnp.asarray(getattr(state, f)[b].numpy()) for f in FIELDS))
            refs.append(reference_rollout(step, jm.params, s, ju, warm))
        out[warm] = (final, traj, refs)
    return name, out


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_simulate_matches_reference(rollouts, warm):
    name, out = rollouts
    final, traj, refs = out[warm]
    assert tuple(traj.x.shape) == (T, 3) + tuple(final.x.shape[1:])
    for b, (ref_state, ref_info) in enumerate(refs):
        for f in FIELDS:
            close(getattr(traj, f)[:, b], ref_state[f], 1e-10, f"{name} lane {b} {f}")
        for f in INFO:
            got, ref = getattr(traj.info, f)[:, b].numpy(), ref_info[f]
            if f in ("success", "iterations", "rescued"):
                np.testing.assert_array_equal(got, ref, err_msg=f"{name} lane {b} {f}")
            else:
                close(got, ref, 1e-10, f"{name} lane {b} info.{f}")
    assert bool(traj.info.success.all())


def test_warm_start_saves_iterations(rollouts):
    """The warm chain takes no more Newton iterations than the cold one."""
    _, out = rollouts
    cold, warm = out[False][1].info.iterations, out[True][1].info.iterations
    assert int(warm.sum()) <= int(cold.sum())


def test_simulate_steps_as_make_step():
    """make_simulate over 5 steps, cold and warm, equals make_step stepped
    by hand: the pre-step states, each StepInfo, the final state, and the
    warm chain's first w_prev from init_w."""
    jm = jmodels.get_mechanism("pendulum")
    mech = port_mechanism(jm, "pendulum")
    state = lanes(mech, "pendulum")
    n, opts = 5, SolverOptions(**OPTS)
    us = pad_inputs(mech.topo, torch.as_tensor(np.array(U["pendulum"]))).expand(n, 3, -1, -1)
    sim = make_simulate(mech.topo, opts, device="cpu")
    step = make_step(mech.topo, opts, device="cpu")
    for warm in (False, True):
        final, traj = sim(mech.params, state, us, warm_start=warm)
        s, w_prev = state, step.init_w(state.v, state.w, mech.params) if warm else None
        for t in range(n):
            for f in FIELDS:
                assert torch.equal(getattr(traj, f)[t], getattr(s, f)), (warm, t, f)
            s, info = step(mech.params, s, us[t], w_prev=w_prev)
            w_prev = info.w if warm else None
            for f in INFO:
                assert torch.equal(getattr(traj.info, f)[t], getattr(info, f)), (warm, t, f)
        for f in FIELDS:
            assert torch.equal(getattr(final, f), getattr(s, f)), (warm, f)
        assert bool(traj.info.success.all())


@pytest.fixture(scope="module")
def traced():
    """tests/test_solver_trace.py's case (pendulum, rtol = btol = 1e-10,
    max_iter 8) on three lanes: the port's solve and solve.traced."""
    jm = jmodels.get_mechanism("pendulum", timestep=0.01)
    mech = port_mechanism(jm, "pendulum")
    opts = dict(rtol=1e-10, btol=1e-10, max_iter=8)
    state = lanes(mech, "pendulum")
    init_w, solve, _ = make_solver(mech.topo, device="cpu")
    ctx = make_context(mech.topo, state, mech.params)
    w0 = init_w(state.v, state.w, mech.params)
    res = solve(w0, ctx, mech.params, SolverOptions(**opts))
    res_t, trace = solve.traced(w0, ctx, mech.params, SolverOptions(**opts))
    return jm, state, res, res_t, trace, opts


def test_traced_matches_solve(traced):
    _, _, res, res_t, trace, opts = traced
    assert bool(res.success.all()) and bool(res_t.success.all())
    assert torch.equal(res_t.iterations, res.iterations)
    close(res_t.w, res.w, 1e-12, "w")
    n = res.iterations
    steps = torch.arange(opts["max_iter"])[:, None]
    assert torch.equal(trace["valid"], steps < n[None, :])
    last = trace["rvio"].gather(0, (n - 1)[None].long())
    assert bool((last < opts["rtol"]).all())
    assert not bool(res_t.rescued.any())


def test_traced_matches_reference(traced):
    """The port's trace against dojo_tpu's solve.traced, lane by lane."""
    jm, state, _, res_t, trace, opts = traced
    j_init, j_solve, _ = j_make_solver(jm.topo)
    j_traced = jax.jit(j_solve.traced, static_argnums=3)
    for b in range(3):
        s = JState(*(jnp.asarray(getattr(state, f)[b].numpy()) for f in FIELDS))
        jctx = j_make_context(jm.topo, s, jm.params)
        jres, jtrace = j_traced(j_init(s.v, s.w, jm.params), jctx, jm.params, JOpts(**opts))
        close(res_t.w[b], jres.w, 1e-12, f"lane {b} w")
        assert int(res_t.iterations[b]) == int(jres.iterations), b
        np.testing.assert_array_equal(trace["valid"][:, b].numpy(), np.asarray(jtrace["valid"]))
        np.testing.assert_array_equal(trace["undercut"][:, b].numpy(),
                                      np.asarray(jtrace["undercut"]))
        for k in ("rvio", "bvio", "mu"):
            np.testing.assert_allclose(trace[k][:, b].numpy(), np.asarray(jtrace[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"lane {b} {k}")


@pytest.mark.slow
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_simulate_matches_jitted_make_simulate(rollouts, warm):
    """The port's rollout against dojo_tpu's jitted make_simulate (its
    scan), lane by lane."""
    name, out = rollouts
    _, traj, _ = out[warm]
    jm = jmodels.get_mechanism(name)
    sim = jax.jit(jsim.make_simulate(jm.topo, JOpts(**OPTS)), static_argnames="warm_start")
    ju = jnp.broadcast_to(j_pad_inputs(jm.topo, jnp.asarray(U[name])), (T, jm.topo.nj, 6))
    for b in range(3):
        s = JState(*(jnp.asarray(getattr(traj, f)[0, b].numpy()) for f in FIELDS))
        _, jtraj = sim(jm.params, s, ju, warm_start=warm)
        for f in FIELDS:
            close(getattr(traj, f)[:, b], getattr(jtraj, f), 1e-10, f"lane {b} {f}")
        for f in INFO:
            close(getattr(traj.info, f)[:, b].numpy(), getattr(jtraj.info, f), 1e-10,
                  f"lane {b} info.{f}")


def test_mechanism_surface_matches_dojo_tpu():
    """Mechanism's surface against dojo_tpu's on the pendulum: parameters by
    name (get and set), the minimal ↔ maximal maps and set_minimal; and
    step / simulate on a state without a lane axis equal make_step's and
    make_simulate's lane."""
    jm = jmodels.get_mechanism("pendulum", springs=1.0, dampers=0.2)
    mech = port_mechanism(jm, "pendulum", springs=1.0, dampers=0.2)
    for got, ref in ((mech.get_body("pendulum"), jm.get_body("pendulum")),
                     (mech.get_joint("joint"), jm.get_joint("joint"))):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-15, err_msg=k)
    p = mech.set_joint("joint", spring=3.0, damper=0.5)
    jp = jm.set_joint("joint", spring=3.0, damper=0.5)
    for f in ("tra_spring", "rot_spring", "tra_damper", "rot_damper"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)), f)
    assert mech.params is p
    s0 = models.initialize(mech, "pendulum", angle=0.4, angular_velocity=-0.3)
    js0 = JState(*(jnp.asarray(getattr(s0, f).numpy()) for f in FIELDS))
    y = mech.minimal_state(s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jm.minimal_state(js0)), atol=1e-12)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(mech.maximal_state(y), f).numpy(),
                                   np.asarray(getattr(jm.maximal_state(jnp.asarray(y.numpy())), f)),
                                   atol=1e-12, err_msg=f)
        got = getattr(mech.set_minimal(s0, "joint", coords=[0.7]), f).numpy()
        ref = np.asarray(getattr(jm.set_minimal(js0, "joint", coords=[0.7]), f))
        np.testing.assert_allclose(got, ref, atol=1e-12, err_msg=f)
    opts = SolverOptions(**OPTS)
    s1, info = mech.step(s0, u=[0.3], opts=opts)
    lane = BodyState(*(getattr(s0, f)[None] for f in FIELDS))
    ref, ref_info = make_step(mech.topo, opts, device="cpu")(
        mech.params, lane, pad_inputs(mech.topo, torch.tensor([[0.3]], dtype=torch.float64)))
    assert tuple(s1.x.shape) == tuple(s0.x.shape) and bool(info.success)
    for f in FIELDS:
        assert torch.equal(getattr(s1, f), getattr(ref, f)[0]), f
    final, traj = mech.simulate(s0, 3, opts=opts)
    assert tuple(traj.x.shape) == (3,) + tuple(s0.x.shape) and traj.info.w.shape[0] == 3
    assert torch.equal(traj.x[0], s0.x)
