"""The port's trot-MPC layer (mpc/trot.py, mpc/ilqr.py rt path) against
dojo_tpu, float64 on the CPU.

The trot helpers are held to dojo_tpu's to 1e-12.  The Riccati pass, the
rt cost and sanitize run on seeded random knots (one of them NaN) through
both packages, to 1e-10.  One control step of the port's make_trot_rt at
H=2 on two perturbed scenario lanes checks the pick semantics of the line
search; the same step against dojo_tpu's, which compiles the whole JAX
controller, is in test_torch_mpc_ref.py (slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu.mpc import ilqr as jilqr
from dojo_tpu.mpc import trot as jtrot
from dojo_tpu_torch import convert, models
from dojo_tpu_torch.core import SolverOptions, tensor_map
from dojo_tpu_torch.gradients import to_minimal
from dojo_tpu_torch.mpc import Trace, ilqr, trot

RT = dict(rtol=1e-4, btol=1e-3, max_iter=16, rescue=True)
SPEC = trot.TrotSpec()


@pytest.fixture(scope="module")
def mechs():
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    tm = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    return jm, tm


def _helper_pairs(jm, tm):
    """(port value, dojo_tpu value) of each trot helper on the same inputs."""
    kw = dict(pos_x=0.1, vx_w=7.0, joint_w=1.5, reg=3.0, du_max=2.0, r_mul=2.0, kff=0.5)
    tg, jg = trot.trot_gains(tm, **kw), jtrot.trot_gains(jm, **kw)
    tp, jp = trot.trot_spring_params(tm, 30.0, 3.0), jtrot.trot_spring_params(jm, 30.0, 3.0)
    tc, jc = trot.trot_cost(tm), jtrot.trot_cost(jm)
    return {
        "reference": (trot.trot_reference(tm, 0.13, 5, 0.05, SPEC),
                      jtrot.trot_reference(jm, 0.13, 5, 0.05, jtrot.TrotSpec())),
        "cost": ([tc.Q, tc.R, tc.Qf], [jc.Q, jc.R, jc.Qf]),
        "actuated": (trot.actuated_indices(tm), jtrot.actuated_indices(jm)),
        "ff_layout": (trot._ff_layout(tm, SPEC), jtrot._ff_layout(jm, jtrot.TrotSpec())),
        "gains": (list(tg), list(jg)),
        "spring_params": ([tp.rot_spring, tp.rot_damper, tp.rot_spring_offset],
                          [jp.rot_spring, jp.rot_damper, jp.rot_spring_offset]),
        "weight_schedule": (
            trot.trot_weight_schedule(tm, 0.07, 5, 0.05, SPEC, tg.Qd, 2.0, 0.5),
            jtrot.trot_weight_schedule(jm, 0.07, 5, 0.05, jtrot.TrotSpec(), jg.Qd, 2.0, 0.5)),
    }


@pytest.mark.parametrize("name", ["reference", "cost", "actuated", "ff_layout", "gains",
                                  "spring_params", "weight_schedule"])
def test_trot_helpers_match(mechs, name):
    got, ref = _helper_pairs(*mechs)[name]
    got, ref = (got if isinstance(got, (list, tuple)) else [got]), (
        ref if isinstance(ref, (list, tuple)) else [ref])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


def test_gains_from_numpy(mechs):
    jm, _ = mechs
    jg = jtrot.trot_gains(jm, kff=0.5)
    g = convert.gains_from_numpy({f: np.asarray(getattr(jg, f)) for f in jg._fields},
                                 device="cpu")
    assert isinstance(g, trot.TrotGains)
    for f in jg._fields:
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))


# ---- the runtime-gains Riccati pass, cost and sanitize -----------------------

H, LANES = 3, 2


@pytest.fixture(scope="module")
def cores(mechs):
    jm, tm = mechs
    act = trot.actuated_indices(tm)
    jcore = jilqr._make_rt_core(jm.topo, H, JOpts(**RT), act, "auto")
    tcore = ilqr._make_rt_core(tm.topo, H, SolverOptions(**RT), act, "auto", device="cpu")
    rng = np.random.default_rng(11)
    ny, nu = 36, 12
    data = dict(
        As=np.eye(ny) + 0.1 * rng.standard_normal((LANES, H, ny, ny)),
        Bs=0.1 * rng.standard_normal((LANES, H, ny, nu)),
        ys=rng.standard_normal((LANES, H + 1, ny)),
        us=rng.standard_normal((LANES, H, nu)),
        goals=rng.standard_normal((H + 1, ny)),
        Qd=rng.uniform(0.5, 2.0, (H + 1, ny)),
        Rd=rng.uniform(0.01, 0.1, nu),
        Qfd=rng.uniform(0.5, 2.0, ny),
        reg=0.5,
    )
    data["As"][1, 1, 3, 4] = np.nan  # one non-finite knot
    return jcore, tcore, data


def _both(cores, fn, names):
    """fn's port value on all lanes, and dojo_tpu's lane by lane, stacked."""
    jcore, tcore, data = cores
    t = fn(tcore, *(torch.as_tensor(np.asarray(data[n])) for n in names))
    per_lane = lambda n: n in ("As", "Bs", "ys", "us")
    lanes = [fn(jcore, *(jnp.asarray(data[n][b] if per_lane(n) else data[n]) for n in names))
             for b in range(LANES)]
    t = t if isinstance(t, tuple) else (t,)
    lanes = [x if isinstance(x, tuple) else (x,) for x in lanes]
    return [a.numpy() for a in t], [np.stack([np.asarray(x[i]) for x in lanes])
                                   for i in range(len(t))]


def test_sanitize_matches(cores):
    got, ref = _both(cores, lambda c, A, B: c.sanitize(A, B), ["As", "Bs"])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[0][1, 1], np.eye(36))  # the NaN knot → (I, 0)
    assert not got[1][1, 1].any() and np.isfinite(got[0]).all()


def test_cost_rt_matches(cores):
    got, ref = _both(cores, lambda c, *a: c.cost_rt(*a), ["ys", "us", "goals", "Qd", "Rd", "Qfd"])
    np.testing.assert_allclose(got[0], ref[0][:, 0] if ref[0].ndim > 1 else ref[0],
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("sanitized", [False, True], ids=["with_nan_knot", "sanitized"])
def test_backward_rt_matches(cores, sanitized):
    def fn(c, As, Bs, *rest):
        if sanitized:
            As, Bs = c.sanitize(As, Bs)
        return c.backward_rt(As, Bs, *rest)

    got, ref = _both(cores, fn, ["As", "Bs", "ys", "us", "goals", "Qd", "Rd", "Qfd", "reg"])
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        assert finite.any() and (sanitized == finite.all())
        scale = np.abs(r[finite]).max()
        np.testing.assert_allclose(g[finite], r[finite], rtol=0, atol=1e-10 * scale)


# ---- one control step of make_trot_rt ----------------------------------------


@pytest.fixture(scope="module")
def control(mechs):
    _, tm = mechs
    Hc, alphas = 2, (1.0, 0.5)
    s0 = models.initialize(tm, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(tm.topo, tm.params, tensor_map(lambda a: a[None], s0))
    rng = np.random.default_rng(0)
    pert = np.zeros((LANES, 36))
    pert[:, :2] = rng.normal(scale=0.01, size=(LANES, 2))
    pert[:, 6:9] = rng.normal(scale=0.02, size=(LANES, 3))
    ys = y0 + torch.as_tensor(pert)
    params = trot.trot_spring_params(tm, 40.0, 4.0)
    mpc, ref_fn, _ = trot.make_trot_rt(tm, horizon=Hc, opts=SolverOptions(**RT), dt=0.05,
                                       alphas=alphas, device="cpu")
    g = trot.trot_gains(tm, joint_w=1.0, reg=10.0, du_max=1e9, kff=0.0)
    g = g._replace(Qd=g.Qd.expand(Hc + 1, 36))
    dus = 0.05 * torch.as_tensor(rng.standard_normal((LANES, Hc, 12)))
    trace = Trace()
    out = mpc(params, ys, dus, ref_fn(0.0), *g, trace=trace)
    return dict(out=out, trace=trace, dus=dus, Hc=Hc, na=len(alphas))


def test_control_step_picks(control):
    """Finite outputs; a scenario keeps the best α only if it lowers the
    rollout's cost, else it keeps the rollout (its warm controls, shifted)."""
    u0, dus_next, c, okf = control["out"]
    counts = control["trace"].counts
    for a in (u0, dus_next, c, okf):
        assert bool(torch.isfinite(a).all())
    assert tuple(u0.shape) == (LANES, 12) and tuple(dus_next.shape) == (LANES, control["Hc"], 12)
    c0 = counts["rollout"]["cost"]
    assert bool((c <= c0).all())
    assert torch.equal(counts["forward"]["cost"], c)
    improved = c < c0
    assert int(counts["forward"]["improved"]) == int(improved.sum())
    assert int(counts["forward"]["best_alpha"].sum()) == LANES
    warm = control["dus"]
    shifted = torch.cat([warm[:, 1:], warm[:, -1:]], 1)
    for b in range(LANES):
        if not improved[b]:
            assert torch.equal(dus_next[b], shifted[b]) and torch.equal(u0[b], warm[b, 0])
    assert bool(((okf >= 0) & (okf <= 1)).all())


def test_control_step_counts(control):
    """The trace counts every contact solve: H knots of the rollout on B
    lanes, H knots of the forward pass on B·nα lanes."""
    counts, Hc, na = control["trace"].counts, control["Hc"], control["na"]
    assert (counts["rollout"]["solves"], counts["rollout"]["lanes"]) == (Hc, Hc * LANES)
    assert (counts["forward"]["solves"], counts["forward"]["lanes"]) == (Hc, Hc * LANES * na)
    assert counts["linearize"]["knots"] == Hc * LANES
    assert int(counts["rollout"]["iterations"]) >= Hc * LANES
    assert set(control["trace"].ms) == {"rollout", "linearize", "backward", "forward"}


def test_linearize_chunks_match(mechs):
    """Linearizing in knot chunks gives what one batch of all knots gives
    (at the cone-neutral init, a point the IFT formula takes as well as a
    solution)."""
    _, tm = mechs
    act = trot.actuated_indices(tm)
    cost = trot.trot_cost(tm)
    parts = [ilqr._make_parts(tm.topo, cost, 2, ilqr.ILQRConfig(linearize_chunk=k),
                              SolverOptions(**RT), act, device="cpu") for k in (0, 1)]
    params = trot.trot_spring_params(tm, 40.0, 4.0)
    s0 = models.initialize(tm, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(tm.topo, params, tensor_map(lambda a: a[None], s0))
    rng = np.random.default_rng(5)
    ys = y0 + 0.01 * torch.as_tensor(rng.standard_normal((LANES, 3, 36)))
    us = 0.3 * torch.as_tensor(rng.standard_normal((LANES, 2, 12)))
    ws = parts[0].w_seed(params, ys[:, :2].reshape(-1, 36)).reshape(LANES, 2, -1)
    mus = torch.full((LANES, 2), 1e-3, dtype=ys.dtype)
    whole, chunked = (p.linearize(params, ys, us, ws, mus) for p in parts)
    for a, b in zip(whole, chunked):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
