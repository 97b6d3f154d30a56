"""gradients.make_rollout_linearize_minimal of the port against dojo_tpu,
float64 on the CPU, and the shared-factorization solve and matvec.

One quadruped knot: the standing pose (body_position (0, 0, −0.13)) with
its base position and velocity perturbed and random joint inputs, under the
trot controller's spring params, all made with numpy from a seed and handed
to both packages.  The port solves the step (step_w) and linearizes at its
own (w*, μ).  The reference A, B are formed with numpy from JAX Jacobians
of dojo_tpu's own functions at that point: the residual in w (plus REG·I),
in the maximal state and in the packed inputs (through make_context and
pad_inputs), minimal_to_maximal in y, and the output map (next state, then
maximal_to_minimal) in the state and in w.  No JAX solver and no JAX
linearize is compiled here; test_torch_mpc_ref.py (slow) holds dojo_tpu's
own linearize against the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import quadruped_kkt

from dojo_tpu import lie as jlie
from dojo_tpu import models as jmodels
from dojo_tpu.core import REG
from dojo_tpu.core import BodyState as JState
from dojo_tpu.minimal import maximal_to_minimal as j_to_minimal
from dojo_tpu.minimal import minimal_to_maximal as j_to_maximal
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import make_residual as j_make_residual
from dojo_tpu.residual import pad_inputs as j_pad_inputs
from dojo_tpu.solver import make_solver as j_make_solver
from dojo_tpu_torch import ldu, models
from dojo_tpu_torch.core import SolverOptions, tensor_map
from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_maximal, to_minimal
from dojo_tpu_torch.mpc import trot_spring_params
from dojo_tpu_torch.residual import pad_inputs
from dojo_tpu_torch.solver import make_solver

OPTS = SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30)


@pytest.fixture(scope="module")
def case():
    mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    topo = mech.topo
    params = trot_spring_params(mech, 40.0, 4.0)
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    rng = np.random.default_rng(3)
    y = to_minimal(topo, params, tensor_map(lambda a: a[None], s0)).numpy()
    y[:, :2] += rng.normal(scale=0.01, size=(1, 2))
    y[:, 6:9] += rng.normal(scale=0.02, size=(1, 3))
    u = rng.normal(scale=0.5, size=(1, topo.input_dim))
    yt, ut = torch.as_tensor(y), torch.as_tensor(u)
    step_w, linearize, w_seed = make_rollout_linearize_minimal(topo, OPTS, device="cpu")
    y2, w, mu, ok = step_w(params, yt, ut)
    assert bool(ok.all())
    _, lin_dense, _ = make_rollout_linearize_minimal(topo, OPTS, linsolve="dense", device="cpu")
    st = to_maximal(topo, params, yt)
    init_w = make_solver(topo, device="cpu")[0]
    port = dict(
        y2=y2[0].numpy(), lin=[a[0].numpy() for a in linearize(params, yt, ut, w, mu)],
        dense=[a[0].numpy() for a in lin_dense(params, yt, ut, w, mu)],
        seed=w_seed(params, yt)[0].numpy(),
        warm=init_w(st.v, st.w, params, w_prev=w, warm_floor=OPTS.warm_floor)[0].numpy(),
    )
    return dict(topo=topo, params=params, y=y[0], u=u[0], w=w[0].numpy(),
                mu=float(mu[0]), port=port)


@pytest.fixture(scope="module")
def reference(case):
    """A, B and the next state from dojo_tpu's functions at the port's knot."""
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    topo, nb = jm.topo, jm.topo.nb
    p = jm.params._replace(**{f: jnp.asarray(getattr(case["params"], f).numpy())
                              for f in jm.params._fields})
    y, u, w, mu = (jnp.asarray(case[k]) for k in ("y", "u", "w", "mu"))
    res = j_make_residual(topo)

    def to_z(y_):
        return j_to_maximal(topo, p, y_).pack()

    def r_of(w_, z_, u_):
        ctx = j_make_context(topo, JState.unpack(z_, nb), p, j_pad_inputs(topo, u_))
        return res(w_, ctx, p, mu)

    def out_of(z_, w_):
        st = JState.unpack(z_, nb)
        bv = w_[: 6 * nb].reshape(nb, 6)
        nxt = JState(x=jlie.next_position(st.x, bv[:, :3], p.timestep),
                     q=jlie.next_orientation(st.q, bv[:, 3:], p.timestep),
                     v=bv[:, :3], w=bv[:, 3:])
        return j_to_minimal(topo, p, nxt)

    def with_value(f):  # the value as jacfwd's aux, from the same trace
        return lambda *a: (lambda v: (v, v))(f(*a))

    Jz, z = jax.jit(jax.jacfwd(with_value(to_z), has_aux=True))(y)
    Rw, Rz, Ru = jax.jit(jax.jacfwd(r_of, argnums=(0, 1, 2)))(w, z, u)
    (Gz, Gw), y2 = jax.jit(jax.jacfwd(with_value(out_of), argnums=(0, 1), has_aux=True))(z, w)
    Jz, Rw, Rz, Ru, Gz, Gw = (np.asarray(a) for a in (Jz, Rw, Rz, Ru, Gz, Gw))
    J = Rw + REG * np.eye(topo.dim)
    dW = -np.linalg.solve(J, np.concatenate([Rz @ Jz, Ru], axis=1))
    ny = topo.minimal_dim
    A = Gz @ Jz + Gw @ dW[:, :ny]
    B = Gw @ dW[:, ny:]
    st = JState.unpack(z, nb)
    init_w = j_make_solver(topo)[0]
    return dict(
        A=A, B=B, y2=np.asarray(y2),
        seed=np.asarray(init_w(st.v, st.w, p)),
        warm=np.asarray(init_w(st.v, st.w, p, w_prev=w, warm_floor=OPTS.warm_floor)),
    )


@pytest.mark.parametrize("k, name", [(0, "A"), (1, "B")])
def test_linearize_matches_jax_jacobians(case, reference, k, name):
    got, ref = case["port"]["lin"][k], reference[name]
    assert got.shape == ref.shape == ((36, 36) if k == 0 else (36, 18))
    tol = 1e-8 * max(1.0, float(np.abs(reference["A"]).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("k", [0, 1], ids=["A", "B"])
def test_linearize_auto_matches_dense(case, k):
    """The graph-LDU path against the dense pivoted LU (linsolve="dense")."""
    np.testing.assert_allclose(case["port"]["lin"][k], case["port"]["dense"][k], rtol=0,
                               atol=1e-9)


def test_step_w_next_state_matches(case, reference):
    """step_w's y2 is maximal_to_minimal of the next state built from w*."""
    np.testing.assert_allclose(case["port"]["y2"], reference["y2"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["seed", "warm"])
def test_init_w_matches(case, reference, name):
    """w_seed (the cone-neutral init) and the warm init from w* (floors)."""
    np.testing.assert_allclose(case["port"][name], reference[name], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def kkt():
    sched, blocks, r = quadruped_kkt(torch.float64, lanes=2)
    plan = ldu.LduPlan(sched, "cpu")
    return plan, blocks, ldu.factorize(plan, blocks)


@pytest.mark.parametrize("k", [1, 3])
def test_shared_factor_solve_and_matvec_equal_repeat(kkt, k):
    """rhs_per_fact=k gives exactly what copying each lane's factors to its
    k right-hand sides gives."""
    plan, blocks, fact = kkt
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((blocks.shape[0] * k, *plan.vec_idx.shape)))
    rep = lambda a: a.repeat_interleave(k, 0)
    got = ldu.solve(plan, fact, x, rhs_per_fact=k)
    assert torch.equal(got, ldu.solve(plan, [rep(a) for a in fact], x))
    got = ldu.matvec(plan, blocks, x, rhs_per_fact=k)
    assert torch.equal(got, ldu.matvec(plan, rep(blocks), x))


def test_pad_inputs_under_vmap(case):
    """pad_inputs is out of place: it runs under torch.func.vmap and jvp."""
    topo = case["topo"]
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((3, topo.input_dim)))
    ref = pad_inputs(topo, u)
    got = torch.func.vmap(lambda v: pad_inputs(topo, v))(u)
    assert torch.equal(got, ref)
    _, tangent = torch.func.jvp(lambda v: pad_inputs(topo, v), (u,), (u,))
    assert torch.equal(tangent, ref)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(
        jax.vmap(lambda v: j_pad_inputs(topo, v))(jnp.asarray(u.numpy()))))
