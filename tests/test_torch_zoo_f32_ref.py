"""Which zoo models dojo_tpu itself cannot step at bench_zoo.py's options in
float32: the record behind chip_smoke.ZOO_REFERENCE_FAILS.

bench_zoo steps each model in float32 at rtol=1e-6, btol=1e-4,
max_iter=30.  For each of its 12 models, dojo_tpu's jitted step runs here
on the CPU in float32, one lane from the state every lane of chip_smoke's
zoo phase starts from (chip_smoke.zoo_state: the initial state made in
float64 and rounded to float32 once), for the ZOO_K steps that the phase
times.  A model whose reference fails at any of
them is exempt from the phase's success gate (success >= 0.9 over those
steps), and only such a model: the test holds ZOO_REFERENCE_FAILS to
exactly that set.  With -s it prints each step's success, iterations and
residual.  Marked slow: 12 XLA compiles of the whole step."""

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from dojo_tpu import models as jmodels
from dojo_tpu.core import SolverOptions
from dojo_tpu.simulate import make_step


@pytest.mark.slow
@pytest.mark.parametrize("name", chip_smoke.ZOO_MODELS)
def test_reference_float32_zoo_step(name):
    mech = jmodels.get_mechanism(name)
    f32 = lambda t: jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    mech.params = f32(mech.params)
    start = chip_smoke.zoo_state(name, "cpu")
    state = type(mech.zero_state())(**{f: jnp.asarray(getattr(start, f).numpy())
                                       for f in ("x", "q", "v", "w")})
    step = jax.jit(lambda p, s: make_step(mech.topo, SolverOptions(rtol=1e-6, btol=1e-4,
                                                                   max_iter=30))(p, s, None))
    oks = []
    for k in range(chip_smoke.ZOO_K):
        state, info = step(mech.params, state)
        oks.append(bool(info.success))
        print(f"{name} step {k}: success {oks[-1]}, {int(info.iterations)} iterations, "
              f"rvio {float(info.rvio):.3g}, bvio {float(info.bvio):.3g}")
        assert bool(jnp.isfinite(state.x).all())
    assert (not all(oks)) == (name in chip_smoke.ZOO_REFERENCE_FAILS), oks
