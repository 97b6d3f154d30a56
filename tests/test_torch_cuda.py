"""The three CUDA kernels against their plain PyTorch versions on a card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py configures JAX for the reference tests.)  The quadruped
KKT helper here also feeds tests/test_torch_ldu.py and
tests/test_torch_ldu_order.py.
"""

import numpy as np
import pytest
import torch

from dojo_tpu_torch import ldu, ldu_cuda as L, models
from dojo_tpu_torch.blocks import make_assembler
from dojo_tpu_torch.core import tensor_map
from dojo_tpu_torch.graph import build_schedule
from dojo_tpu_torch.residual import make_context, make_residual
from dojo_tpu_torch.simulate import make_step

B = 4


def quadruped_kkt(dtype, device="cpu", lanes=B):
    """Quadruped KKT blocks and right-hand side at ``lanes`` lanes, from a seed."""
    mech = models.get_mechanism("quadruped", timestep=0.05, device=device).cast(dtype)
    topo, params = mech.topo, mech.params
    state = tensor_map(lambda a: a.expand(lanes, *a.shape).contiguous(),
                       models.initialize(mech, "quadruped"))
    sched = build_schedule(topo)
    ctx = make_context(topo, state, params, torch.zeros(lanes, topo.nj, 6, dtype=dtype, device=device))
    w0 = make_step(topo, device=device).init_w(state.v, state.w, params)
    noise = np.random.default_rng(0).standard_normal(tuple(w0.shape))
    bw = w0 + 0.01 * torch.as_tensor(noise, dtype=dtype, device=device)
    mu = torch.full((lanes,), 1e-3, dtype=dtype, device=device)
    blocks = make_assembler(topo, sched, device)(bw, ctx, params, mu)
    r = make_residual(topo, device)(bw, ctx, params, mu)
    return sched, blocks.contiguous(), r


def lu_identity_err(fb, lu, ps, n_nodes):
    """max over lanes and nodes of |L·U − PS·D| / max|PS·D|."""
    lower = torch.tril(lu, -1) + torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
    pd = ps @ fb[:, :n_nodes]
    num = (lower @ torch.triu(lu) - pd).abs().amax(dim=(-1, -2))
    return float((num / pd.abs().amax(dim=(-1, -2))).max())


LU_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """The three CUDA kernels against their plain versions on the card
    (float32 and float64), with the test_pallas_ldu.py tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-10)):
        sched, blocks, r = quadruped_kkt(dtype, "cuda")
        ds = L.DeviceSchedule(sched, "cuda")
        L.reset_launches()
        fact = L.factorize(ds, blocks)
        ref = ldu.factorize(ds.plan, blocks)
        assert float((fact[0] - ref[0]).abs().max()) < 5e-3
        assert lu_identity_err(*fact, sched.n_nodes) < LU_TOL[dtype]
        b = L.flat_to_nodes(ds.plan, r).contiguous()
        x = L.solve_refine(ds, blocks, fact, b, 1)
        x_ref = ldu.solve(ds.plan, ref, b)
        x_ref = x_ref + ldu.solve(ds.plan, ref, b - ldu.matvec(ds.plan, blocks, x_ref))
        scale = float(x_ref.abs().max())
        assert float((x - x_ref).abs().max()) / scale < tol
        y = L.matvec(ds, blocks, x)
        mag = ldu.matvec(ds.plan, blocks.abs(), x.abs())
        assert bool(((y - ldu.matvec(ds.plan, blocks, x)).abs() <= 1e-5 * mag + 1e-30).all())
        assert (L.factorize.launches, L.solve.launches, L.matvec.launches) == (1, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3])
def test_factorize_solve_odd_batch_on_cuda(lanes):
    """Factorize and solve at B=1 and an odd B, float32 and float64: the
    factored blocks against the plain version, L·U = PS·D, and the solve
    against the plain solve on the kernel's own factors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-10)):
        sched, blocks, r = quadruped_kkt(dtype, "cuda", lanes)
        ds = L.DeviceSchedule(sched, "cuda")
        fact = L.factorize(ds, blocks)
        ref = ldu.factorize(ds.plan, blocks)
        assert fact[0].shape == (lanes, sched.n_slots, sched.width, sched.width)
        assert float((fact[0] - ref[0]).abs().max()) < 5e-3
        assert lu_identity_err(*fact, sched.n_nodes) < LU_TOL[dtype]
        b = L.flat_to_nodes(ds.plan, r).contiguous()
        x = L.solve(ds, fact, b)
        x_ref = ldu.solve(ds.plan, fact, b)
        assert float((x - x_ref).abs().max()) / float(x_ref.abs().max()) < tol

