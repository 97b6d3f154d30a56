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
knot.  The port is held to dojo_tpu over all knots: its median error at
most 10 times dojo_tpu's median, its largest error at most 10 times
dojo_tpu's largest or 2.5e-4 (chip_smoke's LIN_TOL), and no knot's
smallest float32 pivot at the floor.  Marked slow: dojo_tpu compiles its linearize in float32 and in
float64 (minutes on a CPU host).  With -s it prints both errors per knot,
and the smallest pivot of each package's float32 LU there.

The port once failed it badly: at 10 of 29 plant knots its float32
linearize was off by 9.5 to 6,310 times max(1, |A|∞) where dojo_tpu's was
within 0.017, and at exactly those knots the smallest pivot of its float32
LU was the 1e-12 floor.  The cause was the block LU's rounding: the port
rounded the product of each Schur update apart (dojo_tpu's XLA code fuses
it into one multiply-add) and moved rows exactly (dojo_tpu swaps them
arithmetically), so nearly dependent rows cancelled to exactly 0.
ldu.blu_factor now rounds as dojo_tpu's does (tests/test_torch_ldu_swap.py:
bitwise on the same blocks), and no knot's pivot sits at the floor.  A
knot's error alone is rounding noise on a pivot of ~5e-8: it moves by a
factor of more than 10 at most knots, and up to ~10^3, when w moves by one
ulp (the second test prints it), so a gate knot by knot (each within 10
times dojo_tpu's) compares rounding luck, and failed dojo_tpu itself at 4
knots with the two packages exchanged.  The gate over all knots still
catches the fault above (errors up to 6,310 at pivots on the floor)."""

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
    floored = np.flatnonzero(piv_port <= ldu.pivot_floor(torch.float32)).tolist()
    print(f"median error: port {np.median(port):.3g}, dojo_tpu {np.median(ref):.3g}; "
          f"largest: port {port.max():.3g}, dojo_tpu {ref.max():.3g}")
    assert not floored, f"port float32 LU: smallest pivot at the floor at knots {floored}"
    assert np.median(port) <= 10 * np.median(ref), (
        f"port median error {np.median(port)} over 10x dojo_tpu's {np.median(ref)}")
    assert port.max() <= max(10 * ref.max(), 2.5e-4), (
        f"port largest error {port.max()} over 10x dojo_tpu's {ref.max()} (or 2.5e-4)")


def test_float32_pivots_off_the_floor_under_one_ulp(knots):
    """No knot's smallest float32 pivot is the floor, at the knots and with
    w moved by one ulp at random in each entry (3 seeds).  With -s it
    prints each knot's linearize error, against the port's float64 value
    (held to dojo_tpu's in tier-1), in each of the 4 runs, and the spread
    max/min over the runs."""
    sched = knots["sched"]
    plan = ldu.LduPlan(sched, "cpu")
    opts = SolverOptions(**PLANT)
    lin = {}
    for dtype in (torch.float32, torch.float64):
        mech = models.get_mechanism("quadruped", timestep=0.05, device="cpu").cast(dtype)
        params = trot_spring_params(mech, 40.0, 4.0)
        lin[dtype] = (mech, params, make_rollout_linearize_minimal(mech.topo, opts, device="cpu")[1])
    y, u, w, mu = (torch.as_tensor(knots[f]) for f in ("y", "u", "w", "mu"))
    mech64, p64, lin64 = lin[torch.float64]
    A64, B64 = lin64(p64, y.double(), u.double(), w.double(), mu.double())
    scale = A64.abs().amax(dim=(1, 2)).clamp_min(1.0)
    mech, params, lin32 = lin[torch.float32]
    ctx = make_context(mech.topo, to_maximal(mech.topo, params, y), params,
                       pad_inputs(mech.topo, u))
    assemble = make_assembler(mech.topo, sched, "cpu")
    floor = ldu.pivot_floor(torch.float32)
    errors, pivots = [], []
    for seed in (None, 0, 1, 2):
        wp = w
        if seed is not None:
            rng = np.random.default_rng(seed)
            up = np.where(rng.random(w.shape) < 0.5, np.inf, -np.inf).astype(np.float32)
            wp = torch.as_tensor(np.nextafter(w.numpy(), up))
        A, B = lin32(params, y, u, wp, mu)
        errors.append((torch.maximum((A.double() - A64).abs().amax(dim=(1, 2)),
                                     (B.double() - B64).abs().amax(dim=(1, 2))) / scale).numpy())
        LU = ldu.factorize(plan, assemble(wp, ctx, params, mu))[1]
        pivots.append(LU.diagonal(dim1=-2, dim2=-1).abs().flatten(1).amin(1).numpy())
    errors, pivots = np.array(errors), np.array(pivots)
    fmt = lambda a: np.array2string(a, formatter={"float_kind": lambda v: f"{v:.3g}"})
    for i in range(errors.shape[1]):
        print(f"knot {i}: float32 error in 4 runs {fmt(errors[:, i])}, spread "
              f"{errors[:, i].max() / errors[:, i].min():.3g}; smallest pivot {fmt(pivots[:, i])}")
    assert (pivots > floor).all(), f"pivots at the floor: {np.argwhere(pivots <= floor).tolist()}"
