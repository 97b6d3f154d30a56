"""The residual and the assembled KKT blocks of the zoo models that
dojo_tpu's misc and block modules add (the fixed-joint merge, loop joints,
planar and prismatic joints), against dojo_tpu's, float64, at the model's
initial state with no inputs and a seeded w (its neutral init plus 0.01 of
noise), μ = 1e-3: the residual to 1e-10, the blocks to 1e-10 (fourbar,
which has no schedule: the dense Jacobian its solver factors, to 1e-9).

dojo_tpu's residual and assembler are compiled per model (15-30 s of XLA a
model on a CPU host), so block2d (a planar joint and four contacts in a
38-wide node) is in tier-1 and the other ten are marked slow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu.blocks import make_assembler as j_make_assembler
from dojo_tpu.core import BodyState as JBodyState
from dojo_tpu.graph import build_schedule as j_build_schedule
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import make_residual as j_make_residual
from dojo_tpu_torch import models
from dojo_tpu_torch.blocks import local_jacobian, make_assembler
from dojo_tpu_torch.graph import build_schedule
from dojo_tpu_torch.residual import make_context, make_residual
from dojo_tpu_torch.solver import make_solver

SLOW = ("dzhanibekov", "tippetop", "raiberthopper", "quadrotor", "uuv", "panda", "youbot",
        "exoskeleton", "atlas", "fourbar")


@pytest.mark.parametrize("name", ["block2d"] + [pytest.param(n, marks=pytest.mark.slow)
                                                for n in SLOW])
def test_residual_and_blocks_match_dojo_tpu(name):
    tm = models.get_mechanism(name, device="cpu")
    ts = models.initialize(tm, name)
    topo = tm.topo
    u = torch.zeros(1, topo.nj, 6, dtype=torch.float64)
    state = type(ts)(**{f: getattr(ts, f)[None] for f in "xqvw"})
    ctx = make_context(topo, state, tm.params, u)
    w0 = make_solver(topo, device="cpu")[0](state.v, state.w, tm.params)
    w = w0 + 0.01 * torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(w0.shape)))
    mu = torch.full((1,), 1e-3, dtype=torch.float64)
    res = make_residual(topo, "cpu")
    sched = build_schedule(topo)

    jm = jmodels.get_mechanism(name)
    assert dataclasses.asdict(jm.topo) == dataclasses.asdict(topo)
    jst = JBodyState(**{f: jnp.asarray(getattr(ts, f).numpy()) for f in "xqvw"})
    jctx = j_make_context(jm.topo, jst, jm.params, jnp.zeros((topo.nj, 6)))
    j_res = j_make_residual(jm.topo)
    j_sched = j_build_schedule(jm.topo)
    second = j_make_assembler(jm.topo, j_sched) if j_sched is not None else jax.jacfwd(j_res)
    r_ref, m_ref = jax.jit(lambda *a: (j_res(*a), second(*a)))(
        jnp.asarray(w[0].numpy()), jctx, jm.params, jnp.asarray(1e-3))

    r = res(w, ctx, tm.params, mu)
    np.testing.assert_allclose(r[0].numpy(), np.asarray(r_ref), rtol=0, atol=1e-10)
    if sched is None:
        assert name == "fourbar" and j_sched is None
        J = local_jacobian(lambda v: res(v, ctx, tm.params, mu), w)
        np.testing.assert_allclose(J[0].numpy(), np.asarray(m_ref), rtol=0, atol=1e-9)
    else:
        blocks = make_assembler(topo, sched, "cpu")(w, ctx, tm.params, mu)
        assert blocks.shape == (1, sched.n_slots, sched.width, sched.width)
        np.testing.assert_allclose(blocks[0].numpy(), np.asarray(m_ref), rtol=0, atol=1e-10)
