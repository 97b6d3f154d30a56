"""The quadruped residual, its Jacobian and the assembled KKT blocks of the
port against dojo_tpu, float64, on two lanes at a perturbed point.

Inputs (state perturbation, control inputs, w perturbation, μ) are made
with numpy from a seed and handed to both packages.  The JAX references are
built once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu.blocks import make_assembler as j_make_assembler
from dojo_tpu.graph import build_schedule as j_build_schedule
from dojo_tpu.residual import make_context as j_make_context
from dojo_tpu.residual import make_residual as j_make_residual
from dojo_tpu.residual import pad_inputs as j_pad_inputs
from dojo_tpu.solver import make_solver as j_make_solver
from dojo_tpu_torch import joints, ldu, lie, models
from dojo_tpu_torch.blocks import local_jacobian, make_assembler
from dojo_tpu_torch.core import BodyState
from dojo_tpu_torch.graph import build_schedule
from dojo_tpu_torch.residual import joint_params, make_context, make_residual, pad_inputs
from dojo_tpu_torch.solver import make_solver

B = 2


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    js = jmodels.initialize(jm, "quadruped")
    topo = jm.topo
    st = {f: np.repeat(np.asarray(getattr(js, f))[None], B, axis=0) for f in ("x", "q", "v", "w")}
    st["v"][1] += 0.05 * rng.standard_normal(st["v"][1].shape)
    st["w"][1] += 0.05 * rng.standard_normal(st["w"][1].shape)
    u_packed = 0.1 * rng.standard_normal((B, topo.input_dim))
    tm = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    tstate = BodyState(**{k: torch.as_tensor(a) for k, a in st.items()})
    w0 = make_solver(tm.topo, device="cpu")[0](tstate.v, tstate.w, tm.params).numpy()
    w = w0 + 0.01 * rng.standard_normal(w0.shape)
    mu = np.array([1e-3, 0.0])

    # ---- dojo_tpu, vmapped over the lanes --------------------------------
    jstate = type(js)(**{k: jnp.asarray(a) for k, a in st.items()})
    ju = jax.vmap(lambda uu: j_pad_inputs(topo, uu))(jnp.asarray(u_packed))
    jctx = jax.vmap(lambda s, uu: j_make_context(topo, s, jm.params, uu))(jstate, ju)
    res = j_make_residual(topo)
    args = (jnp.asarray(w), jctx, jm.params, jnp.asarray(mu))
    axes = (0, 0, None, 0)
    ref = dict(
        ctx=jctx,
        u=np.asarray(ju),
        r=np.asarray(jax.jit(jax.vmap(res, in_axes=axes))(*args)),
        J=np.asarray(jax.jit(jax.vmap(jax.jacfwd(res), in_axes=axes))(*args)),
        blocks=np.asarray(jax.jit(jax.vmap(
            j_make_assembler(topo, j_build_schedule(topo)), in_axes=axes))(*args)),
    )

    # ---- the port --------------------------------------------------------
    tu = pad_inputs(tm.topo, torch.as_tensor(u_packed))
    tctx = make_context(tm.topo, tstate, tm.params, tu)
    return dict(ref=ref, tm=tm, u=tu, ctx=tctx, w=torch.as_tensor(w), mu=torch.as_tensor(mu),
                st=st, jm=jm)


def test_pad_inputs_matches(case):
    np.testing.assert_array_equal(case["u"].numpy(), case["ref"]["u"])


@pytest.mark.parametrize("field", ["x1", "q1", "x2", "q2", "jf2", "jt2", "fext", "text"])
def test_context_matches(case, field):
    np.testing.assert_allclose(getattr(case["ctx"], field).numpy(),
                               np.asarray(getattr(case["ref"]["ctx"], field)), rtol=0, atol=1e-12)


def test_residual_matches(case):
    tm = case["tm"]
    r = make_residual(tm.topo, "cpu")(case["w"], case["ctx"], tm.params, case["mu"])
    assert r.shape == (B, 356)
    np.testing.assert_allclose(r.numpy(), case["ref"]["r"], rtol=0, atol=1e-10)


def test_jacobian_matches(case):
    """torch.func forward-mode Jacobian of the whole residual (the dense
    rescue's matrix) against jax.jacfwd."""
    tm = case["tm"]
    res = make_residual(tm.topo, "cpu")
    J = local_jacobian(lambda u: res(u, case["ctx"], tm.params, case["mu"]), case["w"], chunk_size=64)
    assert J.shape == (B, 356, 356)
    np.testing.assert_allclose(J.numpy(), case["ref"]["J"], rtol=0, atol=1e-9)


def test_blocks_match(case):
    tm = case["tm"]
    sched = build_schedule(tm.topo)
    blocks = make_assembler(tm.topo, sched, "cpu")(case["w"], case["ctx"], tm.params, case["mu"])
    assert blocks.shape == (B, 100, 14, 14)
    np.testing.assert_allclose(blocks.numpy(), case["ref"]["blocks"], rtol=0, atol=1e-10)
    # the blocks are the schedule's view of the dense J + REG·I
    extract = ldu.make_ldu(sched, "cpu")[0]
    J = torch.tensor(case["ref"]["J"]) + 1e-10 * torch.eye(356, dtype=torch.float64)
    np.testing.assert_allclose(extract(J).numpy(), blocks.numpy(), rtol=0, atol=1e-10)


def test_init_w_matches(case):
    """Cold init, warm init with floors, and the contact/joint reset."""
    jm, tm, st = case["jm"], case["tm"], case["st"]
    j_init = j_make_solver(jm.topo)[0]
    t_init = make_solver(tm.topo, device="cpu")[0]
    rng = np.random.default_rng(11)
    w_prev = rng.standard_normal((B, 356))
    reset = np.zeros((B, 12), dtype=bool)
    reset[1] = True
    v, w = torch.as_tensor(st["v"]), torch.as_tensor(st["w"])
    for kw in ({}, {"w_prev": w_prev}, {"w_prev": w_prev, "contact_reset": reset}):
        ref = np.stack([
            np.asarray(j_init(jnp.asarray(st["v"][b]), jnp.asarray(st["w"][b]), jm.params,
                              **{k: jnp.asarray(a[b]) for k, a in kw.items()}))
            for b in range(B)
        ])
        got = t_init(v, w, tm.params, **{k: torch.as_tensor(a) for k, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12, err_msg=str(list(kw)))


@pytest.mark.parametrize("relative", ["parent", "child"])
def test_impulse_transforms_match_ad_form(case, relative):
    """Closed-form joint impulse transforms against their AD form (one joint
    at a time, as dojo_tpu's tests/test_joints.py checks them)."""
    tm, st = case["tm"], case["st"]
    jp_all = joint_params(tm.params)
    xs = np.concatenate([np.zeros((1, 3)), st["x"][1]])
    qs = np.concatenate([[[1.0, 0, 0, 0]], st["q"][1]])
    turn = np.array([0.99, 0.1, -0.05, 0.02]) / np.linalg.norm([0.99, 0.1, -0.05, 0.02])
    for j in range(tm.topo.nj):
        jp = {k: a[j] for k, a in jp_all.items()}
        p, c = tm.topo.joint_parent[j] + 1, tm.topo.joint_child[j] + 1
        qc = lie.qmul(torch.as_tensor(qs[c]), torch.as_tensor(turn))  # child turned off the joint manifold
        args = [torch.as_tensor(xs[p]), torch.as_tensor(qs[p]), torch.as_tensor(xs[c]), qc]
        for closed, ad in ((joints.tra_impulse_transform, joints.tra_impulse_transform_ad),
                           (joints.rot_impulse_transform, joints.rot_impulse_transform_ad)):
            torch.testing.assert_close(closed(jp, relative, *args), ad(jp, relative, *args),
                                       rtol=0, atol=1e-12)
