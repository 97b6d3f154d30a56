"""Which zoo models dojo_tpu itself cannot step at bench_zoo.py's options in
float32: the record behind chip_smoke.ZOO_REFERENCE_FAILS; and the port's
float32 steps held to dojo_tpu's, step by step.

bench_zoo steps each model in float32 at rtol=1e-6, btol=1e-4,
max_iter=30.  For each of its 12 models, dojo_tpu's jitted step runs here
on the CPU in float32, one lane from the state every lane of chip_smoke's
zoo phase starts from (chip_smoke.zoo_state: the initial state made in
float64 and rounded to float32 once), for the ZOO_K steps that the phase
times.  A model whose reference fails at any of
them is exempt from the phase's success gate (success >= 0.9 over those
steps), and only such a model: the test holds ZOO_REFERENCE_FAILS to
exactly that set.  Over REF_K steps, each from the reference's own state
(the same float32 bits handed to both), the port's float32 step on the CPU
is held to dojo_tpu's StepInfo: no lane that the port rescues and dojo_tpu
does not (a fault), and, apart, success, Newton iterations and the dense
rescue equal.  And
atlas's drop (chip_smoke's atlas phase) in float32: dojo_tpu fails every
step, which is why the card drops atlas in float64.  With -s each test
prints each step's values.  Marked slow: an XLA compile of the whole step
per model (atlas's ~20 minutes)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dojo_tpu import models as jmodels
from dojo_tpu.core import SolverOptions
from dojo_tpu.simulate import make_step
from dojo_tpu_torch import models
from dojo_tpu_torch.core import BodyState
from dojo_tpu_torch.core import SolverOptions as TOpts
from dojo_tpu_torch.simulate import make_step as t_make_step

OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)
REF_K = 5  # steps held step by step (ROADMAP Queue 3 items 2 and 3)
# The lanes the port rescues and dojo_tpu does not (ROADMAP Queue 3, with
# each step's values): a fault, not fixed yet; xfail, strict, until it is
RESCUED_ALONE = {
    "hopper": "step 2 rescued (29 iterations) where dojo_tpu converges without the "
              "rescue (16)",
    "quadruped": "step 3 rescued (36) where dojo_tpu fails, its rescue too (44)",
}
# Where the port's float32 steps part from dojo_tpu's at all (ROADMAP Queue
# 3 items 2 and 3): (success, iterations, rescued) of the REF_K steps, the
# port's against dojo_tpu's; only ant matches.  xfail, strict, until the
# paths agree
PARTS = {
    "pendulum": "step 2 converges in 4 iterations where dojo_tpu needs the rescue (15)",
    "cartpole": "step 1 fails (38 iterations) where dojo_tpu converges in 2; step 3 "
                "converges in 1 where dojo_tpu fails (37)",
    "sphere": "step 2 converges in 12 where dojo_tpu needs the rescue (25)",
    "npendulum": "every step fails in both; iterations 39/39/37/41/36 against 37/37/36/40/35",
    "block": "step 3 fails (39) where dojo_tpu's rescue converges (19); step 4 rescued in 19 "
             "against 22",
    "hopper": "step 2 rescued (29) where dojo_tpu converges without it (16): a lane the port "
              "rescues and dojo_tpu does not",
    "snake": "every step fails in both; step 4 takes 38 iterations against 39",
    "halfcheetah": "every step fails in both; iterations 57/45/46/42/45 against 45/45/47/46/54",
    "walker": "every step fails in both; iterations 47/50/51/48/44 against 48/60/49/49/45",
    "quadruped": "step 3 rescued (36) where dojo_tpu fails, its rescue too (44): a lane the "
                 "port rescues and dojo_tpu does not; step 0 rescued in 40 against 51",
    "humanoid": "every step fails in both; iterations 40/42/43/39/45 against 42/42/41/44/41",
}


def _f32(t):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)


def _reference(name, start, **kw):
    """dojo_tpu's mechanism in float32, its jitted step, and `start` (a port
    BodyState) as its state."""
    mech = jmodels.get_mechanism(name, **kw)
    mech.params = _f32(mech.params)
    state = type(mech.zero_state())(**{f: jnp.asarray(getattr(start, f).numpy())
                                       for f in ("x", "q", "v", "w")})
    step = jax.jit(lambda p, s: make_step(mech.topo, SolverOptions(**OPTS))(p, s, None))
    return mech, step, state


@pytest.mark.slow
@pytest.mark.parametrize("name", chip_smoke.ZOO_MODELS)
def test_reference_float32_zoo_step(name):
    mech, step, state = _reference(name, chip_smoke.zoo_state(name, "cpu"))
    oks = []
    for k in range(chip_smoke.ZOO_K):
        state, info = step(mech.params, state)
        oks.append(bool(info.success))
        print(f"{name} step {k}: success {oks[-1]}, {int(info.iterations)} iterations, "
              f"rvio {float(info.rvio):.3g}, bvio {float(info.bvio):.3g}")
        assert bool(jnp.isfinite(state.x).all())
    assert (not all(oks)) == (name in chip_smoke.ZOO_REFERENCE_FAILS), oks


def _xfail(reasons):
    return [pytest.param(n, marks=pytest.mark.xfail(strict=True, reason=reasons[n]))
            if n in reasons else n for n in chip_smoke.ZOO_MODELS]


@functools.cache
def _ref_steps(name):
    """REF_K float32 steps, each from dojo_tpu's state after the one before
    (the first from chip_smoke.zoo_state), by the port (the plain path,
    one lane) and by dojo_tpu.  Returns ([(success, iterations, rescued)
    of the port's steps], [dojo_tpu's])."""
    mech, step, state = _reference(name, chip_smoke.zoo_state(name, "cpu"))
    tm = models.get_mechanism(name, device="cpu").cast(torch.float32)
    t_step = t_make_step(tm.topo, TOpts(**OPTS), device="cpu")
    got, want = [], []
    for k in range(REF_K):
        start = BodyState(**{f: torch.as_tensor(np.asarray(getattr(state, f)))[None]
                             for f in ("x", "q", "v", "w")})
        _, tinfo = t_step(tm.params, start)
        state, info = step(mech.params, state)
        got.append((bool(tinfo.success[0]), int(tinfo.iterations[0]), bool(tinfo.rescued[0])))
        want.append((bool(info.success), int(info.iterations), bool(info.rescued)))
        print(f"{name} step {k}: port (success, iterations, rescued) {got[-1]}, "
              f"dojo_tpu {want[-1]}")
        assert bool(jnp.isfinite(state.x).all())
    return got, want


@pytest.mark.slow
@pytest.mark.parametrize("name", _xfail(RESCUED_ALONE))
def test_port_rescues_no_lane_reference_does_not(name):
    """No step of _ref_steps that the port's dense rescue finishes and
    dojo_tpu's does not."""
    got, want = _ref_steps(name)
    assert not any(g[2] and not w[2] for g, w in zip(got, want)), (got, want)


@pytest.mark.slow
@pytest.mark.parametrize("name", _xfail(PARTS))
def test_port_float32_zoo_steps_match_reference(name):
    """Each step of _ref_steps ends with dojo_tpu's success, iterations and
    rescue flag."""
    got, want = _ref_steps(name)
    assert got == want, (got, want)


@pytest.mark.slow
def test_reference_float32_atlas_drop():
    """dojo_tpu's float32 step of chip_smoke's atlas drop (springs 1000,
    dampers 100, 2 cm above standing height) fails every one of the
    phase's ATLAS_K steps at these options, its solve stalling short of
    rtol; so does the port's (the plain path, on the first step)."""
    _, start = chip_smoke.atlas_case(torch.float32, "cpu")
    kw = dict(springs=1000.0, dampers=100.0, parse_springs=False, parse_dampers=False)
    mech, step, state = _reference("atlas", start, **kw)
    oks = []
    for k in range(chip_smoke.ATLAS_K):
        state, info = step(mech.params, state)
        oks.append(bool(info.success))
        print(f"atlas step {k}: success {oks[-1]}, {int(info.iterations)} iterations, "
              f"rescued {bool(info.rescued)}, rvio {float(info.rvio):.3g}")
        assert bool(jnp.isfinite(state.x).all())
    assert not any(oks)
    tm, tstart = chip_smoke.atlas_case(torch.float32, "cpu")
    one = BodyState(**{f: getattr(tstart, f)[None] for f in ("x", "q", "v", "w")})
    _, tinfo = t_make_step(tm.topo, TOpts(**OPTS), device="cpu")(tm.params, one)
    assert not bool(tinfo.success[0])
