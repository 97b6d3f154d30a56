"""The port's differentiable step (gradients.make_diff_step*, the IFT as a
torch.autograd.Function) and its Jacobians against dojo_tpu, float64 on
the CPU.

Every case batches 3 lanes in the port and compares each lane with
dojo_tpu on that lane; parameters go to the port through
convert.params_from_numpy.  Tier-1 compiles no dojo_tpu solver: its
references are dojo_tpu's IFT formed from dojo_tpu's own
functions at the port's solution (w*, μ_f), as dojo_tpu's custom_jvp rule
forms it (gradients.py:55-70): J = ∂r/∂w + REG·I by jacfwd of its
residual, ṙ by jacfwd of the residual in (state, u, params) through its
make_context and pad_inputs, ẇ = −J⁻¹ṙ, and jacfwd of its output map
(next state, then maximal_to_minimal or pack).  The tests marked slow hold
the port to dojo_tpu's own entry points (jacfwd and grad through its
make_diff_step, minimal_jacobians, maximal_jacobians_attjac), which take
minutes of XLA compilation each.

Tolerances: next states within 1e-10; Jacobians and gradients within 1e-8
of their scale (max |reference|, at least 1); reverse mode against forward
mode in the port within 1e-10 relative; the sphere's jvp against central
differences within 1e-4 (tests/test_gradients.py's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import gradients as jg
from dojo_tpu import lie as jlie
from dojo_tpu import models as jmodels
from dojo_tpu.core import REG
from dojo_tpu.core import BodyState as JState
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu.gradients import attitude_jacobian as j_attitude_jacobian
from dojo_tpu.minimal import maximal_to_minimal as j_to_minimal
from dojo_tpu.minimal import minimal_to_maximal as j_to_maximal
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import make_residual as j_make_residual
from dojo_tpu.residual import pad_inputs as j_pad_inputs
from dojo_tpu_torch import models
from dojo_tpu_torch.convert import params_from_numpy
from dojo_tpu_torch.core import BodyState, SolverOptions
from dojo_tpu_torch.gradients import (
    attitude_jacobian,
    finite_difference_jacobian,
    make_diff_step,
    make_diff_step_minimal,
    make_rollout_linearize_minimal,
    maximal_jacobians,
    maximal_jacobians_attjac,
    minimal_jacobians,
    to_maximal,
    to_minimal,
)
from dojo_tpu_torch.residual import pad_inputs
from dojo_tpu_torch.simulate import make_step

TIGHT = dict(rtol=1e-12, btol=1e-12)
CONTACT = dict(rtol=1e-8, btol=1e-8)
UPRIGHT = dict(rtol=1e-10, btol=1e-10)
PEND_Y = np.array([[0.4, 0.7], [0.1, -0.3], [1.0, 0.2]])
PEND_U = np.array([[0.3], [0.0], [-0.5]])
# v0 of the sphere's lanes: each converges in 21-23 iterations (at
# 0.6-0.8 m/s the solve needs more than the default max_iter of 50)
SPHERE_V0 = np.array([1.6, 1.8, 2.0])


def port_mechanism(jm, name, **kw):
    """The port's mechanism with dojo_tpu's params (numpy in between)."""
    mech = models.get_mechanism(name, device="cpu", **kw)
    mech.params = params_from_numpy({f: np.asarray(getattr(jm.params, f))
                                     for f in jm.params._fields}, device="cpu")
    return mech


def rel_err(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _reference_jits(jm, kind, fields):
    """dojo_tpu's pieces, jitted once per topology, kind ("minimal": y ↦
    minimal_to_maximal, out maximal_to_minimal; "maximal": z ↦ unpack, out
    pack) and parameter fields: jacfwd of its residual in (w, x, u, the
    fields) at (w, μ), and its output map with jacfwd in (x, w, the
    fields)."""
    key = (jm.topo, kind, fields)
    if key not in _JITS:
        topo, nb = jm.topo, jm.topo.nb
        res = j_make_residual(topo)
        if kind == "minimal":
            to_state = lambda p, y: j_to_maximal(topo, p, y)
            from_state = lambda p, s: j_to_minimal(topo, p, s)
        else:
            to_state = lambda p, z: JState.unpack(z, nb)
            from_state = lambda p, s: s.pack()

        def r_of(w, x, u, f, p, mu):
            p = p._replace(**f)
            return res(w, j_make_context(topo, to_state(p, x), p, j_pad_inputs(topo, u)), p, mu)

        def out_of(x, w, f, p):
            p = p._replace(**f)
            st = to_state(p, x)
            bv = w[: 6 * nb].reshape(nb, 6)
            nxt = JState(x=jlie.next_position(st.x, bv[:, :3], p.timestep),
                         q=jlie.next_orientation(st.q, bv[:, 3:], p.timestep),
                         v=bv[:, :3], w=bv[:, 3:])
            return from_state(p, nxt)

        jac_out = jax.jacfwd(out_of, argnums=(0, 1, 2))
        _JITS[key] = (jax.jit(jax.jacfwd(r_of, argnums=(0, 1, 2, 3))),
                      jax.jit(lambda x, w, f, p: (out_of(x, w, f, p), jac_out(x, w, f, p))),
                      jax.jit(lambda w, x, u, p, mu: r_of(w, x, u, {}, p, mu)))
    return _JITS[key]


_JITS = {}


def reference_ift(jm, kind, w, mu, x, u, fields=()):
    """dojo_tpu's IFT at one lane's solution (w, μ), as its custom_jvp rule
    forms it: {x2: x', x: ∂x'/∂x, u: ∂x'/∂u, field: ∂x'/∂field} (numpy)."""
    jac_r, jac_out, _ = _reference_jits(jm, kind, fields)
    f = {k: getattr(jm.params, k) for k in fields}
    Rw, Rx, Ru, Rp = jac_r(w, x, u, f, jm.params, mu)
    x2, (Gx, Gw, Gp) = jac_out(x, w, f, jm.params)
    J = np.asarray(Rw) + REG * np.eye(jm.topo.dim)
    Gw = np.asarray(Gw)
    dw = lambda R: -np.linalg.solve(J, np.asarray(R).reshape(jm.topo.dim, -1))
    out = {"x2": np.asarray(x2), "x": np.asarray(Gx) + Gw @ dw(Rx), "u": Gw @ dw(Ru)}
    for k in fields:
        out[k] = np.asarray(Gp[k]).reshape(len(out["x2"]), -1) + Gw @ dw(Rp[k])
    return out


def port_solutions(mech, opts, y, u):
    """(w*, μ_f) of the cold solve the diff step runs, per lane."""
    step_w, _, _ = make_rollout_linearize_minimal(mech.topo, opts, device="cpu")
    _, w, mu, ok = step_w(mech.params, y, u)
    assert bool(ok.all())
    return w, mu


@pytest.fixture(scope="module")
def pend():
    """The pendulum (h = 0.01) at TIGHT options: the port's outputs and
    dojo_tpu's IFT references, lane by lane."""
    jm = jmodels.get_mechanism("pendulum", timestep=0.01)
    mech = port_mechanism(jm, "pendulum", timestep=0.01)
    topo, opts = mech.topo, SolverOptions(**TIGHT)
    y, u = torch.as_tensor(PEND_Y), torch.as_tensor(PEND_U)
    w, mu = port_solutions(mech, opts, y, u)
    z = to_maximal(topo, mech.params, y).pack()
    ref = []
    for b in range(len(PEND_Y)):
        args = (np.asarray(w[b]), float(mu[b]))
        r = reference_ift(jm, "minimal", *args, PEND_Y[b], PEND_U[b],
                          fields=("mass", "timestep"))
        r["max"] = reference_ift(jm, "maximal", *args, z[b].numpy(), PEND_U[b])
        ref.append(r)
    return dict(jm=jm, mech=mech, opts=opts, y=y, u=u, z=z, w=w, ref=ref)


def test_next_state_matches_reference(pend):
    """The diff step's next state: make_step's (whose solve
    tests/test_torch_simulate.py holds to dojo_tpu's), and dojo_tpu's output
    map at its solution; its solution zeroes dojo_tpu's residual."""
    mech = pend["mech"]
    step = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")
    y2 = step(mech.params, pend["y"], pend["u"]).detach()
    state = to_maximal(mech.topo, mech.params, pend["y"])
    nxt, info = make_step(mech.topo, pend["opts"], device="cpu")(
        mech.params, state, pad_inputs(mech.topo, pend["u"]))
    assert bool(info.success.all())
    assert (y2 - to_minimal(mech.topo, mech.params, nxt)).abs().max().item() < 1e-12
    jm = pend["jm"]
    residual = _reference_jits(jm, "minimal", ("mass", "timestep"))[2]
    for b, r in enumerate(pend["ref"]):
        assert np.abs(y2[b].numpy() - r["x2"]).max() < 1e-10, b
        r0 = residual(pend["w"][b].numpy(), PEND_Y[b], PEND_U[b], jm.params, 0.0)
        assert np.abs(np.asarray(r0)).max() < 1e-10, b


def test_stats_count_the_forward_solves(pend):
    """``stats`` counts the diff step's solves as make_step's StepInfo
    reports them, under backward and under torch.func.jvp alike; a solve
    stopped short of its tolerance counts as failed."""
    mech = pend["mech"]
    state = to_maximal(mech.topo, mech.params, pend["y"])
    up = pad_inputs(mech.topo, pend["u"])
    for opts, failed in ((pend["opts"], 0), (dataclasses.replace(pend["opts"], max_iter=1), 3)):
        _, info = make_step(mech.topo, opts, device="cpu")(mech.params, state, up)
        assert int((~info.success).sum()) == failed
        want = dict(solves=2, lanes=6, iterations=2 * int(info.iterations.sum()),
                    rescued=0, failed=2 * failed)
        step = make_diff_step_minimal(mech.topo, opts, device="cpu")
        stats = {}
        u = pend["u"].clone().requires_grad_()
        step(mech.params, pend["y"], u, stats).sum().backward()
        torch.func.jvp(lambda a: step(mech.params, pend["y"], a, stats), (pend["u"],),
                       (torch.ones_like(pend["u"]),))
        assert stats == want, (stats, want)


def test_minimal_jacobians_match_reference(pend):
    A, B = minimal_jacobians(pend["mech"].topo, pend["opts"], device="cpu")(
        pend["mech"].params, pend["y"], pend["u"])
    for b, r in enumerate(pend["ref"]):
        assert rel_err(A[b], r["x"]) < 1e-8, (b, rel_err(A[b], r["x"]))
        assert rel_err(B[b], r["u"]) < 1e-8, (b, rel_err(B[b], r["u"]))


def test_gradients_match_reference(pend):
    """backward() of Σ over lanes of Σ y'² into u, mass and timestep (shared
    parameters: the sum over lanes of each lane's gradient)."""
    mech = pend["mech"]
    step = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")
    u = pend["u"].clone().requires_grad_()
    mass = mech.params.mass.clone().requires_grad_()
    h = mech.params.timestep.clone().requires_grad_()
    y2 = step(dataclasses.replace(mech.params, mass=mass, timestep=h), pend["y"], u)
    (y2 * y2).sum().backward()
    ref_u = np.stack([2 * r["x2"] @ r["u"] for r in pend["ref"]])
    ref_m = sum(2 * r["x2"] @ r["mass"] for r in pend["ref"])
    ref_h = sum(2 * r["x2"] @ r["timestep"] for r in pend["ref"])
    assert rel_err(u.grad, ref_u) < 1e-8
    assert rel_err(mass.grad, ref_m) < 1e-8
    assert rel_err(h.grad, ref_h[0]) < 1e-8


def test_reverse_matches_forward(pend):
    """The Function's backward against its jvp (torch.func.jvp) along one
    direction in (y, u, mass), in the port alone."""
    mech = pend["mech"]
    step = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")

    def loss(y, u, mass):
        y2 = step(dataclasses.replace(mech.params, mass=mass), y, u)
        return (y2 * y2).sum()

    args = (pend["y"], pend["u"], mech.params.mass)
    rng = np.random.default_rng(1)
    dirs = tuple(torch.as_tensor(rng.normal(size=a.shape)) for a in args)
    leaves = [a.clone().requires_grad_() for a in args]
    loss(*leaves).backward()
    terms = torch.cat([(a.grad * d).flatten() for a, d in zip(leaves, dirs)])
    _, fwd = torch.func.jvp(loss, args, dirs)
    assert abs(fwd.item() - terms.sum().item()) < 1e-10 * terms.abs().sum().item()


def test_maximal_jacobians_match_reference(pend):
    mech, topo = pend["mech"], pend["mech"].topo
    fz, fu = maximal_jacobians(topo, pend["opts"], device="cpu")(mech.params, pend["z"],
                                                                 pend["u"])
    Az, Bz = maximal_jacobians_attjac(topo, pend["opts"], device="cpu")(mech.params, pend["z"],
                                                                        pend["u"])
    nb = topo.nb
    assert Az.shape == (3, 12 * nb, 12 * nb) and Bz.shape == (3, 12 * nb, topo.input_dim)
    for b, r in enumerate(pend["ref"]):
        m = r["max"]
        assert rel_err(fz[b], m["x"]) < 1e-8 and rel_err(fu[b], m["u"]) < 1e-8, b
        g_in = np.asarray(j_attitude_jacobian(jnp.asarray(pend["z"][b].numpy()), nb))
        g_out = np.asarray(j_attitude_jacobian(jnp.asarray(m["x2"]), nb))
        assert rel_err(attitude_jacobian(pend["z"][b], nb), g_in) < 1e-14
        assert rel_err(Az[b], g_out.T @ m["x"] @ g_in) < 1e-8, b
        assert rel_err(Bz[b], g_out.T @ m["u"]) < 1e-8, b


def sphere_lanes(mech):
    lanes = [models.initialize(mech, "sphere", position=(0, 0, 0.52), velocity=(v, 0, 0))
             for v in SPHERE_V0]
    return BodyState(*(torch.stack([getattr(s, f) for s in lanes]) for f in "xqvw"))


def test_data_vector_roundtrip_and_grad(pend):
    """Mechanism.get_data / with_data: dojo_tpu's vector, an exact round
    trip, and the gradient of a 3-step loss through the whole vector, its
    mass entry against central differences (tests/test_gradients.py's)."""
    jm, mech = pend["jm"], pend["mech"]
    vec = mech.get_data()
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jm.get_data()))
    p2 = mech.with_data(vec)
    for f in mech._DATA_FIELDS:
        assert torch.equal(getattr(p2, f), getattr(mech.params, f)), f
    step = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")
    y0, u = pend["y"], pend["u"]

    def loss(v):
        y = y0
        for _ in range(3):
            y = step(mech.with_data(v), y, u)
        return (y * y).sum()

    v = vec.clone().requires_grad_()
    loss(v).backward()
    assert bool(torch.isfinite(v.grad).all())
    eps = 1e-6
    e = torch.zeros_like(vec)
    e[0] = eps
    with torch.no_grad():
        fd = (loss(vec + e) - loss(vec - e)).item() / (2 * eps)
    np.testing.assert_allclose(v.grad[0].item(), fd, rtol=1e-5, atol=1e-8)


# ---- against dojo_tpu's own entry points: minutes of XLA compilation each ----


@pytest.mark.slow
@pytest.mark.parametrize("name, opts", [("pendulum", TIGHT), ("cartpole", UPRIGHT)])
def test_minimal_jacobians_match_dojo_tpu(name, opts):
    """The port's minimal_jacobians against dojo_tpu's (jacfwd of its diff
    step), lane by lane."""
    jm = jmodels.get_mechanism(name, timestep=0.01)
    mech = port_mechanism(jm, name, timestep=0.01)
    rng = np.random.default_rng(2)
    y = rng.normal(scale=0.3, size=(3, mech.topo.minimal_dim))
    u = rng.normal(scale=0.3, size=(3, mech.topo.input_dim))
    A, B = minimal_jacobians(mech.topo, SolverOptions(**opts), device="cpu")(
        mech.params, torch.as_tensor(y), torch.as_tensor(u))
    jac = jax.jit(jg.minimal_jacobians(jm.topo, JOpts(**opts)))
    for b in range(3):
        fy, fu = jac(jm.params, jnp.asarray(y[b]), jnp.asarray(u[b]))
        assert rel_err(A[b], fy) < 1e-8 and rel_err(B[b], fu) < 1e-8, b


@pytest.mark.slow
def test_grads_match_jax_grad(pend):
    """The next state and backward() of the port against dojo_tpu's diff
    step and jax.grad of it, in u and in mass, lane by lane, and a 3-step
    loss through with_data."""
    jm, mech = pend["jm"], pend["mech"]
    j_step = jg.make_diff_step_minimal(jm.topo, JOpts(**TIGHT))
    y2 = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")(
        mech.params, pend["y"], pend["u"]).detach().numpy()
    for b in range(3):
        ref = jax.jit(j_step)(jm.params, jnp.asarray(PEND_Y[b]), jnp.asarray(PEND_U[b]))
        assert np.abs(y2[b] - np.asarray(ref)).max() < 1e-10, b

    def j_loss(u, mass, y):
        y2 = j_step(jm.params._replace(mass=mass), y, u)
        return jnp.sum(y2 ** 2)

    g = jax.jit(jax.grad(j_loss, argnums=(0, 1)))
    step = make_diff_step_minimal(mech.topo, pend["opts"], device="cpu")
    for b in range(3):
        u = pend["u"][b : b + 1].clone().requires_grad_()
        mass = mech.params.mass.clone().requires_grad_()
        y2 = step(dataclasses.replace(mech.params, mass=mass), pend["y"][b : b + 1], u)
        (y2 * y2).sum().backward()
        gu, gm = g(jnp.asarray(PEND_U[b]), jm.params.mass, jnp.asarray(PEND_Y[b]))
        assert rel_err(u.grad[0], gu) < 1e-8 and rel_err(mass.grad, gm) < 1e-8, b

    vec = mech.get_data()

    def j_data_loss(v):
        y = jnp.asarray(PEND_Y[0])
        for _ in range(3):
            y = j_step(jm.with_data(v), y, jnp.asarray(PEND_U[0]))
        return jnp.sum(y ** 2)

    ref = jax.jit(jax.grad(j_data_loss))(jm.get_data())
    v = vec.clone().requires_grad_()
    y = pend["y"][:1]
    for _ in range(3):
        y = step(mech.with_data(v), y, pend["u"][:1])
    (y * y).sum().backward()
    assert rel_err(v.grad, ref) < 1e-8


@pytest.mark.slow
def test_maximal_attjac_and_sphere_match_dojo_tpu(pend):
    """maximal_jacobians_attjac against dojo_tpu's (pendulum), and the
    sphere's ∂z'/∂v0 against jacfwd of dojo_tpu's make_diff_step."""
    jm, mech = pend["jm"], pend["mech"]
    Az, Bz = maximal_jacobians_attjac(mech.topo, pend["opts"], device="cpu")(
        mech.params, pend["z"], pend["u"])
    jac = jax.jit(jg.maximal_jacobians_attjac(jm.topo, JOpts(**TIGHT)))
    for b in range(3):
        ra, rb = jac(jm.params, jnp.asarray(pend["z"][b].numpy()), jnp.asarray(PEND_U[b]))
        assert rel_err(Az[b], ra) < 1e-8 and rel_err(Bz[b], rb) < 1e-8, b

    js = jmodels.get_mechanism("sphere", timestep=0.01)
    sph = port_mechanism(js, "sphere", timestep=0.01)
    step = make_diff_step(sph.topo, SolverOptions(**CONTACT), device="cpu")
    s0 = sphere_lanes(sph)
    j_step = jax.jit(jg.make_diff_step(js.topo, JOpts(**CONTACT)))
    u0 = jnp.zeros((js.topo.nj, 6))

    def j_out(v0, s):
        return j_step(js.params, s._replace(v=s.v.at[0, 0].set(v0)), u0).pack()

    v0 = torch.as_tensor(SPHERE_V0)

    def out(v):
        vel = torch.cat([v[:, None, None], s0.v[..., 1:]], dim=-1)
        return step(sph.params, dataclasses.replace(s0, v=vel)).pack()

    _, jv = torch.func.jvp(out, (v0,), (torch.ones_like(v0),))
    jfwd = jax.jit(jax.jacfwd(j_out))
    for b in range(3):
        s = JState(*(jnp.asarray(getattr(s0, f)[b].numpy()) for f in "xqvw"))
        assert rel_err(jv[b], jfwd(jnp.asarray(SPHERE_V0[b]), s)) < 1e-8, b
    eps = 1e-5
    fd = (out(v0 + eps) - out(v0 - eps)) / (2 * eps)
    assert (jv - fd).abs().max().item() < 1e-4


def test_finite_difference_jacobian():
    """The host-side central-difference tool on a known map."""
    f = lambda x: np.array([x[0] ** 2 * x[1], np.sin(x[1])])
    J = finite_difference_jacobian(f, np.array([1.5, 0.3]))
    np.testing.assert_allclose(J, [[2 * 1.5 * 0.3, 1.5 ** 2], [0.0, np.cos(0.3)]], atol=1e-8)
