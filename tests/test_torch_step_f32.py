"""The float32 quadruped step (bench.py's dtype) of the port.

Two lanes (the initial state, and hips turned by 0.1 rad), one cold step at
h=0.05, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30), against the
float64 step of the same lanes.  The float64 path is the one
tests/test_torch_step.py holds to dojo_tpu lane by lane at 1e-8.  Also the
dense rescue pass, and why an airborne lane is left out of the float32
comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import make_residual as j_make_residual
from dojo_tpu_torch import ldu_cuda as L
from dojo_tpu_torch import models
from dojo_tpu_torch.core import BodyState, SolverOptions
from dojo_tpu_torch.residual import make_context, make_residual
from dojo_tpu_torch.simulate import make_step

OPTS = SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30)
FIELDS = ("x", "q", "v", "w")
LANES = ({}, {"hip_angle": 0.1})
AIRBORNE = {"body_position": (0, 0, 0.1)}


def _mech(dtype):
    return models.get_mechanism("quadruped", timestep=0.05, device="cpu").cast(dtype)


def _state(mech, lanes):
    states = [models.initialize(mech, "quadruped", **kw) for kw in lanes]
    return BodyState(*(torch.stack([getattr(s, f) for s in states]) for f in FIELDS))


def _step(dtype, lanes):
    mech = _mech(dtype)
    return make_step(mech.topo, OPTS, device="cpu")(mech.params, _state(mech, lanes))


@pytest.fixture(scope="module")
def reference():
    s1, info = _step(torch.float64, LANES)
    assert info.success.all()
    return {f: getattr(s1, f).numpy() for f in FIELDS}


def _assert_within_solver_tolerance(s1, ref):
    """Both solves stop once rvio < 1e-6, so a float32 and a float64
    solution agree to the solver tolerance, not to rounding: a momentum
    residual of 1e-6 on a link of inertia ~1e-4 kg·m² (mass 0.17 kg) leaves
    angular velocities free by ~1e-2 and linear ones by ~1e-3; positions
    and orientations move by h and h/2 times those."""
    for f, atol in (("x", 5e-5), ("q", 2.5e-4), ("v", 1e-3), ("w", 1e-2)):
        np.testing.assert_allclose(getattr(s1, f).numpy(), ref[f], rtol=0, atol=atol, err_msg=f)


def test_float32_step_matches_float64(reference):
    s1, info = _step(torch.float32, LANES)
    assert s1.x.dtype == torch.float32
    assert info.success.all() and not info.rescued.any()
    _assert_within_solver_tolerance(s1, reference)


def test_float32_rescue_finishes_a_failed_lane(reference, monkeypatch):
    """The dense rescue pass: with lane 1's block factorization poisoned
    (NaN LU), its Newton directions are NaN, the line search keeps the
    incumbent, the no-progress undercut escalates and the float32 stall
    exit hands the lane to the dense pivoted LU, which solves it from the
    neutral init.  Lane 0 is untouched."""
    factorize = L.factorize

    def poisoned(ds, blocks):
        fb, lu, ps = factorize(ds, blocks)
        lu = lu.clone()
        lu[1] = float("nan")
        return fb, lu, ps

    monkeypatch.setattr(L, "factorize", poisoned)
    s1, info = _step(torch.float32, LANES)
    assert info.rescued.tolist() == [False, True]
    assert info.success.all()
    assert int(info.iterations[1]) > 4  # four stalled LDU iterations, then the rescue
    _assert_within_solver_tolerance(s1, reference)


def test_float32_trunk_momentum_floor():
    """Why an airborne lane is left out: with the trunk 10 cm higher
    (x ≈ 0.53 m), the float32 residual of its vertical momentum row,
    m/h·(x3 − x2), rounds to more than rtol=1e-6 at the float64 solution —
    in the port and in dojo_tpu's jitted residual alike — so whether the
    float32 solve converges there depends on rounding."""
    s64, info = _step(torch.float64, [AIRBORNE])
    assert info.success.all()
    mech = _mech(torch.float32)
    s = _state(mech, [AIRBORNE])
    w = info.w.float()
    r = make_residual(mech.topo, "cpu")(w, make_context(mech.topo, s, mech.params), mech.params, 0.0)
    body = r[0, : 6 * mech.topo.nb].abs()
    assert int(body.argmax()) == 2  # trunk, z row
    assert 1e-6 < float(body.max()) < 1e-5

    jm = jmodels.get_mechanism("quadruped", timestep=0.05).cast(jnp.float32)
    js = type(jm.zero_state())(*(jnp.asarray(getattr(s, f)[0].numpy()) for f in FIELDS))
    jr = jax.jit(j_make_residual(jm.topo))(
        jnp.asarray(w[0].numpy()), j_make_context(jm.topo, js, jm.params), jm.params, 0.0
    )
    np.testing.assert_allclose(np.abs(np.asarray(jr[: 6 * mech.topo.nb])).max(),
                               float(body.max()), rtol=0.2)
