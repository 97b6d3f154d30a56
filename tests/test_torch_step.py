"""One batched quadruped step of the port against dojo_tpu, lane by lane.

Two lanes (the initial state, and the same 10 cm higher), h=0.05,
SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30) as bench.py's steps phase,
float64: a cold step, then two warm steps carrying w_prev.  The second warm
step is a contact transient on the first lane (a foot about to touch) and
not on the second, so it goes through the warm-onset re-centering and the
plain warm start.  success and iterations must be equal, w and the next
state within 1e-8.  The float32 step is in test_torch_step_f32.py.

The JAX side runs dojo_tpu's own make_step on the CPU (the jnp LDU path,
as dojo_tpu's tests run it).  Its solve closure is wrapped in jax.jit so
that the cold and warm steps share one compiled solve (the step's other,
cheap, operations run op by op); that changes where JAX compiles, not
what it computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dojo_tpu.simulate as jsim
from dojo_tpu import models as jmodels
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu_torch import lie, models
from dojo_tpu_torch.contacts import signed_distances
from dojo_tpu_torch.core import BodyState, SolverOptions
from dojo_tpu_torch.simulate import make_step

OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)
FIELDS = ("x", "q", "v", "w")
LANES = ({}, {"body_position": (0, 0, 0.1)})


@pytest.fixture(scope="module")
def initial():
    """Both lanes' initial states, built by the port (equal to dojo_tpu's:
    tests/test_torch_model.py) and handed to both packages as numpy."""
    mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    return {f: np.stack([getattr(s, f).numpy() for s in _lanes(mech)]) for f in FIELDS}


def _lanes(mech):
    return [models.initialize(mech, "quadruped", **kw) for kw in LANES]


@pytest.fixture(scope="module")
def reference(initial):
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    make_solver = jsim.make_solver

    def make_solver_jit(topo, linsolve="auto"):
        init_w, solve, violations = make_solver(topo, linsolve=linsolve)
        return init_w, jax.jit(solve, static_argnums=3), violations

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "make_solver", make_solver_jit)
        step = jsim.make_step(jm.topo, JOpts(**OPTS))
    cold = jax.vmap(lambda s: step(jm.params, s))
    warm = jax.vmap(lambda s, wp: step(jm.params, s, w_prev=wp))
    s = type(jm.zero_state())(**{f: jnp.asarray(a) for f, a in initial.items()})
    out = []
    for k in range(3):
        s, info = cold(s) if k == 0 else warm(s, info.w)
        out.append(({f: np.asarray(getattr(s, f)) for f in FIELDS},
                    {f: np.asarray(getattr(info, f)) for f in ("success", "iterations", "w")}))
    return out


@pytest.fixture(scope="module")
def port64(initial):
    mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    step = make_step(mech.topo, SolverOptions(**OPTS), device="cpu")
    s = BodyState(**{f: torch.as_tensor(a) for f, a in initial.items()})
    out, w_prev = [], None
    for _ in range(3):
        pred = BodyState(lie.next_position(s.x, s.v, 0.05), lie.next_orientation(s.q, s.w, 0.05),
                         s.v, s.w)
        s, info = step(mech.params, s, w_prev=w_prev)
        transient = None
        if w_prev is not None:
            touch = signed_distances(mech.topo, mech.params, pred) < 0.05
            active = w_prev[:, mech.topo.contact_off:].reshape(-1, 12, 8)[..., 4] > 0.1
            transient = (touch != active).any(-1).tolist()
        out.append((s, info, transient))
        w_prev = info.w
    return out


@pytest.mark.parametrize("k", [0, 1, 2], ids=["cold", "warm", "warm_transient"])
def test_step_matches_reference(reference, port64, k):
    ref_state, ref_info = reference[k]
    s, info, transient = port64[k]
    if k == 2:  # the re-centering branch ran on lane 0, not on lane 1
        assert transient == [True, False]
    np.testing.assert_array_equal(info.success.numpy(), ref_info["success"])
    assert info.success.all()
    np.testing.assert_array_equal(info.iterations.numpy(), ref_info["iterations"])
    np.testing.assert_allclose(info.w.numpy(), ref_info["w"], rtol=0, atol=1e-8)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(s, f).numpy(), ref_state[f], rtol=0, atol=1e-8,
                                   err_msg=f)
    assert not info.rescued.any()
