"""One trot-MPC control step of the port against dojo_tpu's, float64.

make_trot_rt at H=2, α ∈ {1, 0.5}, on two scenario lanes started from the
standing pose (body_position (0, 0, −0.13)) with bench.py's perturbation of
the base position and velocity (numpy seed 0), with the controller's solver
options of bench.py (rtol 1e-4, btol 1e-3, max_iter 16, rescue), spring
params trot_spring_params(40, 4), gains trot_gains(joint_w=1, reg=10,
du_max=1e9, kff=0) with Qd broadcast to (H+1, ny), and goals
trot_reference(0).  u0, dus_next and the cost agree to 1e-6 relative, okf
exactly; dojo_tpu's own linearize agrees with the port's at one knot to
1e-8 of max(1, |A|∞).

Marked slow: dojo_tpu compiles the whole controller (its rollout and
α-batched forward scans of contact solves, and the linearization) with XLA
on the CPU, about five minutes; the tier-1 tests of the same functions
(test_torch_mpc.py, test_torch_gradients.py) compile no JAX solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu import mpc as jmpc
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu.gradients import make_rollout_linearize_minimal as j_make_rlm
from dojo_tpu_torch import models
from dojo_tpu_torch.core import SolverOptions, tensor_map
from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_minimal
from dojo_tpu_torch.mpc import make_trot_rt, trot_gains, trot_spring_params

H, LANES, ALPHAS = 2, 2, (1.0, 0.5)
RT = dict(rtol=1e-4, btol=1e-3, max_iter=16, rescue=True)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def inputs():
    mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(mech.topo, mech.params, tensor_map(lambda a: a[None], s0))[0].numpy()
    rng = np.random.default_rng(0)
    pert = np.zeros((LANES, y0.size))
    pert[:, :2] = rng.normal(scale=0.01, size=(LANES, 2))  # base xy
    pert[:, 6:9] = rng.normal(scale=0.02, size=(LANES, 3))  # base velocity
    return dict(mech=mech, ys=y0[None] + pert, dus=np.zeros((LANES, H, 12)))


@pytest.fixture(scope="module")
def port(inputs):
    mech = inputs["mech"]
    mpc, ref_fn, _ = make_trot_rt(mech, horizon=H, opts=SolverOptions(**RT), dt=0.05,
                                  alphas=ALPHAS, device="cpu")
    g = trot_gains(mech, joint_w=1.0, reg=10.0, du_max=1e9, kff=0.0)
    g = g._replace(Qd=g.Qd.expand(H + 1, -1))
    out = mpc(trot_spring_params(mech, 40.0, 4.0), torch.as_tensor(inputs["ys"]),
              torch.as_tensor(inputs["dus"]), ref_fn(0.0), *g)
    return [a.numpy() for a in out]


@pytest.fixture(scope="module")
def reference(inputs):
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    mpc, ref_fn, _ = jmpc.make_trot_rt(jm, horizon=H, opts=JOpts(**RT), dt=0.05, alphas=ALPHAS)
    g = jmpc.trot_gains(jm, joint_w=1.0, reg=10.0, du_max=1e9, kff=0.0)
    g = g._replace(Qd=jnp.broadcast_to(g.Qd, (H + 1, jm.topo.minimal_dim)))
    run = jax.jit(jax.vmap(mpc, in_axes=(None, 0, 0, None) + (None,) * 6))
    out = run(jmpc.trot_spring_params(jm, 40.0, 4.0), jnp.asarray(inputs["ys"]),
              jnp.asarray(inputs["dus"]), ref_fn(0.0), *g)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("k, name", [(0, "u0"), (1, "dus_next"), (2, "cost")])
def test_control_step_matches_reference(port, reference, k, name):
    got, ref = port[k], reference[k]
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1e-12, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) / scale < 1e-6, name


def test_okf_matches_reference(port, reference):
    np.testing.assert_array_equal(port[3], reference[3])


def test_linearize_matches_reference(inputs):
    """dojo_tpu's linearize at the port's (y, u, w*, μ) of one knot."""
    mech = inputs["mech"]
    params = trot_spring_params(mech, 40.0, 4.0)
    opts = SolverOptions(**RT)
    step_w, linearize, _ = make_rollout_linearize_minimal(mech.topo, opts, device="cpu")
    y = torch.as_tensor(inputs["ys"][:1])
    u = torch.as_tensor(np.random.default_rng(1).normal(scale=0.5, size=(1, mech.topo.input_dim)))
    _, w, mu, ok = step_w(params, y, u)
    assert bool(ok.all())
    A, B = (a[0].numpy() for a in linearize(params, y, u, w, mu))

    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    _, j_lin, _ = j_make_rlm(jm.topo, JOpts(**RT))
    jA, jB = j_lin(jmpc.trot_spring_params(jm, 40.0, 4.0), jnp.asarray(y[0].numpy()),
                   jnp.asarray(u[0].numpy()), jnp.asarray(w[0].numpy()), jnp.asarray(mu[0].numpy()))
    tol = 1e-8 * max(1.0, float(np.abs(np.asarray(jA)).max()))
    np.testing.assert_allclose(A, np.asarray(jA), rtol=0, atol=tol)
    np.testing.assert_allclose(B, np.asarray(jB), rtol=0, atol=tol)
