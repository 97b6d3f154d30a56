"""Float32 linearize at plant-tolerance knots: the port against dojo_tpu.

At the plant's solver options (rtol 1e-6, btol 1e-4, so μ ends at 1e-5),
the float32 LDU linearize of the port was found far off its float64 value
at some knots.  This test asks whether dojo_tpu's float32 linearize, the
same block elimination with one refinement sweep, is off at the same
knots.  Knots: 32 standing quadruped lanes (h=0.05, body_position
(0, 0, −0.13), trot_spring_params(40, 4)) with base position and velocity
perturbed and random joint inputs (numpy, seed 0), stepped by the port's
float32 step_w at the plant's options on the CPU; the knots kept are those
that converged with μ at 1e-5.  At those same float32
knots both packages linearize in float32, and dojo_tpu in float64 gives
the value both are held to: error = max(|ΔA|, |ΔB|) / max(1, |A|∞) per
knot.  The port is held to dojo_tpu: at every knot its error is at most
10 times dojo_tpu's, or 2.5e-4 (chip_smoke's LIN_TOL) where dojo_tpu's is
smaller.  Marked slow: dojo_tpu compiles its linearize in float32 and in
float64 (minutes on a CPU host).  With -s it prints both errors per knot,
and the smallest pivot of each package's float32 LU there.

The port fails it: at 10 of the 29 plant knots the port's float32
linearize is off by 9.5 to 6,310 times max(1, |A|∞) where dojo_tpu's is
within 0.017, and at exactly those knots the smallest pivot of the port's
float32 LU is the 1e-12 floor (a port fault, ROADMAP Queue 3).  The test is
a strict xfail until that fault is fixed: the fix turns it into an
unexpected pass, which fails the run until the marker goes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import ldu as jldu
from dojo_tpu import models as jmodels
from dojo_tpu import mpc as jmpc
from dojo_tpu.core import SolverOptions as JOpts
from dojo_tpu.gradients import make_rollout_linearize_minimal as j_make_rlm
from dojo_tpu_torch import ldu, models
from dojo_tpu_torch.blocks import make_assembler
from dojo_tpu_torch.core import SolverOptions, tensor_map
from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_maximal, to_minimal
from dojo_tpu_torch.graph import build_schedule
from dojo_tpu_torch.residual import make_context, pad_inputs
from dojo_tpu_torch.mpc import trot_spring_params

PLANT = dict(rtol=1e-6, btol=1e-4, max_iter=30)
LANES = 32

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def knots():
    """The port's float32 plant knots (y, u, w, μ) as numpy float32."""
    mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu").cast(torch.float32)
    params = trot_spring_params(mech, 40.0, 4.0)
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(mech.topo, params, tensor_map(lambda a: a[None], s0))[0].numpy()
    rng = np.random.default_rng(0)
    y = np.repeat(y0[None], LANES, 0)
    y[:, :2] += rng.normal(scale=0.01, size=(LANES, 2))
    y[:, 6:9] += rng.normal(scale=0.02, size=(LANES, 3))
    u = rng.normal(scale=0.5, size=(LANES, mech.topo.input_dim)).astype(np.float32)
    step_w, linearize, _ = make_rollout_linearize_minimal(mech.topo, SolverOptions(**PLANT),
                                                          device="cpu")
    yt, ut = torch.as_tensor(y), torch.as_tensor(u)
    _, w, mu, ok = step_w(params, yt, ut)
    # the knots at the plant's tolerance: solved, μ down to btol / undercut
    keep = (ok & ((mu - 1e-5).abs() < 1e-9)).numpy()
    assert keep.sum() >= 8
    yt, ut, w, mu = yt[keep], ut[keep], w[keep], mu[keep]
    A, B = linearize(params, yt, ut, w, mu)
    # the KKT blocks linearize factors, for the diagnosis printed below
    sched = build_schedule(mech.topo)
    ctx = make_context(mech.topo, to_maximal(mech.topo, params, yt), params,
                       pad_inputs(mech.topo, ut))
    blocks = make_assembler(mech.topo, sched, "cpu")(w, ctx, params, mu)
    return dict(y=yt.numpy(), u=ut.numpy(), w=w.numpy(), mu=mu.numpy(), A=A.numpy(),
                B=B.numpy(), sched=sched, blocks=blocks)


def _min_pivots(knots):
    """Per knot, the smallest |U_ii| over the nodes of the float32 LDU
    factorization of the knot's blocks: the port's plain LDU, dojo_tpu's
    jnp LDU, and the port's in float64 of the same float32 blocks."""
    sched, blocks = knots["sched"], knots["blocks"]
    plan = ldu.LduPlan(sched, "cpu")
    piv = lambda LU: np.abs(np.diagonal(np.asarray(LU), axis1=-2, axis2=-1)).min(axis=(1, 2))
    _, jfact, _, _ = jldu.make_ldu(sched)
    return (piv(ldu.factorize(plan, blocks)[1]),
            piv(jax.jit(jax.vmap(jfact))(jnp.asarray(blocks.numpy()))[1]),
            piv(ldu.factorize(plan, blocks.double())[1]))


def _dojo_tpu_linearize(k, dtype):
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    cast = lambda t: jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
    params = cast(jmpc.trot_spring_params(jm, 40.0, 4.0))
    _, lin, _ = j_make_rlm(jm.topo, JOpts(**PLANT))
    args = [jnp.asarray(k[f], dtype) for f in ("y", "u", "w", "mu")]
    A, B = jax.jit(jax.vmap(lin, in_axes=(None, 0, 0, 0, 0)))(params, *args)
    return np.asarray(A, np.float64), np.asarray(B, np.float64)


@pytest.mark.xfail(strict=True, reason="port fault, ROADMAP Queue 3: the float32 block LU "
                   "floors a pivot that cancels to 0 where dojo_tpu's keeps a noise pivot")
def test_float32_linearize_at_plant_knots(knots):
    A64, B64 = _dojo_tpu_linearize(knots, jnp.float64)
    A32, B32 = _dojo_tpu_linearize(knots, jnp.float32)
    scale = np.maximum(1.0, np.abs(A64).max(axis=(1, 2)))
    err = lambda A, B: np.maximum(np.abs(A - A64).max(axis=(1, 2)),
                                  np.abs(B - B64).max(axis=(1, 2))) / scale
    port, ref = err(knots["A"], knots["B"]), err(A32, B32)
    piv_port, piv_ref, piv_64 = _min_pivots(knots)
    for i in range(len(port)):
        print(f"knot {i}: port float32 {port[i]:.3g}, dojo_tpu float32 {ref[i]:.3g} "
              f"of max(1, |A|inf) = {scale[i]:.3g}; smallest LU pivot: port float32 "
              f"{piv_port[i]:.3g}, dojo_tpu float32 {piv_ref[i]:.3g}, float64 {piv_64[i]:.3g}")
    bad = [i for i in range(len(port)) if port[i] > max(10 * ref[i], 2.5e-4)]
    assert not bad, f"port float32 linearize off at knots {bad}: {port[bad]} vs {ref[bad]}"
