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


def model_kkt(name, dtype, device="cpu", lanes=B, **kwargs):
    """A zoo model's KKT blocks and right-hand side at ``lanes`` copies of its
    initial state, at the neutral init plus 0.01 of noise from a seed,
    μ = 1e-3; ``kwargs`` go to get_mechanism."""
    mech = models.get_mechanism(name, device=device, **kwargs).cast(dtype)
    topo, params = mech.topo, mech.params
    state = tensor_map(lambda a: a.expand(lanes, *a.shape).contiguous(),
                       models.initialize(mech, name))
    sched = build_schedule(topo)
    ctx = make_context(topo, state, params, torch.zeros(lanes, topo.nj, 6, dtype=dtype, device=device))
    w0 = make_step(topo, device=device).init_w(state.v, state.w, params)
    noise = np.random.default_rng(0).standard_normal(tuple(w0.shape))
    bw = w0 + 0.01 * torch.as_tensor(noise, dtype=dtype, device=device)
    mu = torch.full((lanes,), 1e-3, dtype=dtype, device=device)
    blocks = make_assembler(topo, sched, device)(bw, ctx, params, mu)
    r = make_residual(topo, device)(bw, ctx, params, mu)
    return sched, blocks.contiguous(), r


def quadruped_kkt(dtype, device="cpu", lanes=B):
    """Quadruped KKT blocks and right-hand side at ``lanes`` lanes, from a seed."""
    return model_kkt("quadruped", dtype, device, lanes, timestep=0.05)


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



@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 54])
def test_shared_factor_solve_matvec_on_cuda(k):
    """solve and matvec with rhs_per_fact=k (k right-hand sides read each
    lane's factors in place) against their plain versions on the card,
    float32 and float64, with the test_pallas_ldu.py tolerances; the
    shapes of a knot's 54 tangent columns in linearize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-10)):
        sched, blocks, _ = quadruped_kkt(dtype, "cuda")
        ds = L.DeviceSchedule(sched, "cuda")
        fact = L.factorize(ds, blocks)
        noise = np.random.default_rng(k).standard_normal((blocks.shape[0] * k, 356))
        b = L.flat_to_nodes(ds.plan, torch.as_tensor(noise, dtype=dtype, device="cuda"))
        b = b.contiguous()
        L.reset_launches()
        x = L.solve_refine(ds, blocks, fact, b, 1, rhs_per_fact=k)
        assert (L.solve.launches, L.matvec.launches) == (2, 1)
        x_ref = ldu.solve(ds.plan, fact, b, k)
        x_ref = x_ref + ldu.solve(ds.plan, fact, b - ldu.matvec(ds.plan, blocks, x_ref, k), k)
        assert x.shape == b.shape
        assert float((x - x_ref).abs().max()) / float(x_ref.abs().max()) < tol
        y = L.matvec(ds, blocks, x, k)
        mag = ldu.matvec(ds.plan, blocks.abs(), x.abs(), k)
        assert bool(((y - ldu.matvec(ds.plan, blocks, x, k)).abs() <= 1e-5 * mag + 1e-30).all())
        with pytest.raises(ValueError):
            L.solve(ds, fact, b[:-1].contiguous(), k) if k > 1 else L.matvec(ds, blocks, b, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 54])
def test_shared_factor_kernels_match_plain_on_cuda(k):
    """The W <= 16 shared-factor solve (one CTA per factorization and chunk
    of its k columns, for k > 1) and the staged matvec (every k) against
    their plain versions on the same factors, at an odd B, float32 and
    float64: the solve without refinement to 2e-5 / 1e-10 of its scale, the
    matvec within 1e-5·Σ|E||x|; the launches with k > 1 are counted in
    ``shared_launches`` (float64 at k=3 takes 2 chunks of 2 columns, the
    last shorter, and at k=54 27 chunks of 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lanes = 5
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-10)):
        sched, blocks, _ = quadruped_kkt(dtype, "cuda", lanes)
        ds = L.DeviceSchedule(sched, "cuda")
        fact = L.factorize(ds, blocks)
        noise = np.random.default_rng(k).standard_normal((lanes * k, 356))
        b = L.flat_to_nodes(ds.plan, torch.as_tensor(noise, dtype=dtype, device="cuda"))
        b = b.contiguous()
        L.reset_launches()
        x = L.solve(ds, fact, b, k)
        y = L.matvec(ds, blocks, b, k)
        torch.cuda.synchronize()
        assert (L.solve.launches, L.matvec.launches) == (1, 1)
        shared = int(k > 1)
        assert (L.solve.shared_launches["w16"], L.matvec.shared_launches["w16"]) == (shared, shared)
        x_ref = ldu.solve(ds.plan, fact, b, k)
        assert float((x - x_ref).abs().max()) / float(x_ref.abs().max()) < tol
        mag = ldu.matvec(ds.plan, blocks.abs(), b.abs(), k)
        assert bool(((y - ldu.matvec(ds.plan, blocks, b, k)).abs() <= 1e-5 * mag + 1e-30).all())


def _check_class(name, dtype, lanes, k=1):
    """One model's KKT through its width class's three kernels against the
    plain versions, with chip_smoke.check_kernels' limits (factored blocks
    relative to their scale; the solve unrefined on the kernel's factors
    against the plain solve on the same factors, then refined once), and
    in the 17..32 and 33..72 classes every block LU and PS bitwise equal to
    ldu.blu_factor's of the block the kernel factored (float32 and
    float64); a lane that does not fit a CTA in the real-width classes takes
    the kernels of csrc/ldu_lane.cu (atlas: the packed factorize and solve,
    the lane matvec), in W <= 16 raises ValueError (never the plain
    version)."""
    f32 = dtype == torch.float32
    tol = 2e-5 if f32 else 1e-10
    sched, blocks, r = model_kkt(name, dtype, "cuda", lanes)
    ds = L.DeviceSchedule(sched, "cuda")
    try:
        L.smem_layout(sched, "factorize", dtype)
    except ValueError:
        with pytest.raises(ValueError, match="bytes of shared memory"):
            L.factorize(ds, blocks)
        return
    var = {fn.__name__: L.variant(sched, fn.__name__, dtype)
           for fn in (L.factorize, L.solve, L.matvec)}
    cls = var["factorize"]
    assert var["solve"] == cls and var["matvec"] == ("lane" if cls == "packed" else cls)
    L.reset_launches()
    fact = L.factorize(ds, blocks)
    ref = ldu.factorize(ds.plan, blocks)
    assert float((fact[0] - ref[0]).abs().max()) / float(ref[0].abs().max()) < (
        2e-5 if f32 else 1e-12)
    assert lu_identity_err(*fact, sched.n_nodes) < LU_TOL[dtype]
    if cls != "w16":
        import chip_smoke as C

        res = C.lu_vs_plain(sched, *fact)
        assert res["blocks"] == lanes * sched.n_nodes and res["differ"] == 0, res
    noise = np.random.default_rng(k).standard_normal((lanes * k, r.shape[-1]))
    flat = r.repeat_interleave(k, 0) + torch.as_tensor(noise, dtype=dtype, device="cuda")
    b = L.flat_to_nodes(ds.plan, flat).contiguous()
    x0, x0_ref = L.solve(ds, fact, b, k), ldu.solve(ds.plan, fact, b, k)
    scale0 = float(x0_ref.abs().max())
    lim = 1e-12
    if f32:  # 4x the plain float32 solve's own error against float64, at least 2e-5
        x0_64 = ldu.solve(ds.plan, [f.double() for f in fact], b.double(), k)
        lim = max(2e-5, 4 * float((x0_ref.double() - x0_64).abs().max()) / scale0)
    assert float((x0 - x0_ref).abs().max()) / scale0 < lim
    x = L.solve_refine(ds, blocks, fact, b, 1, rhs_per_fact=k)
    x_ref = ldu.solve(ds.plan, ref, b, k)
    x_ref = x_ref + ldu.solve(ds.plan, ref, b - ldu.matvec(ds.plan, blocks, x_ref, k), k)
    assert float((x - x_ref).abs().max()) / float(x_ref.abs().max()) < tol
    y = L.matvec(ds, blocks, x, k)
    mag = ldu.matvec(ds.plan, blocks.abs(), x.abs(), k)
    assert bool(((y - ldu.matvec(ds.plan, blocks, x, k)).abs() <= 1e-5 * mag + 1e-30).all())
    assert (L.factorize.launches, L.solve.launches, L.matvec.launches) == (1, 3, 2)
    for fn in (L.factorize, L.solve, L.matvec):
        assert fn.class_launches[var[fn.__name__]] == fn.launches


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 64])
@pytest.mark.parametrize("name", ["pendulum", "snake", "hopper", "walker", "humanoid",
                                  "twister", "block", "uuv", "block2d", "quadrotor", "atlas"])
def test_width_classes_match_plain_on_cuda(name, lanes):
    """Each width class (pendulum W=6; snake, hopper, walker, humanoid,
    twister, uuv W=22; block, quadrotor W=70, block2d W=38) and the
    kernels of csrc/ldu_lane.cu (atlas, W=38, a lane over a CTA at its real
    rows: packed factorize and solve, lane matvec) against the plain versions,
    float32 and float64, odd batches included; block's float64 lane fits a
    CTA at the factorize's real widths and runs through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for dtype in (torch.float32, torch.float64):
        _check_class(name, dtype, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 54])
def test_lane_kernels_several_rhs_on_cuda(k):
    """Atlas's packed solve with k right-hand sides a factorization (a CTA
    a column) and the lane matvec at k vectors, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _check_class("atlas", torch.float32, 2, k)


@pytest.mark.cuda
def test_shared_factor_w17_32_on_cuda():
    """rhs_per_fact k=54 on the 17..32 class (humanoid, float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _check_class("humanoid", torch.float32, 4, k=54)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 54])
@pytest.mark.parametrize("name", ["humanoid", "walker"])
def test_matvec_w17_32_on_cuda(name, k):
    """The 17..32 matvec (each block staged as its real rows, a thread a
    real output row) with k vectors a lane against the plain version at
    an odd B, float32 and float64, within 1e-5·Σ|E||x|; its pad rows are
    the vectors' own entries, exactly; with k > 1 it is counted in
    ``shared_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lanes = 3
    for dtype in (torch.float32, torch.float64):
        sched, blocks, _ = model_kkt(name, dtype, "cuda", lanes)
        ds = L.DeviceSchedule(sched, "cuda")
        noise = np.random.default_rng(k).standard_normal((lanes * k, sched.n_nodes, sched.width))
        x = torch.as_tensor(noise, dtype=dtype, device="cuda")
        L.reset_launches()
        y = L.matvec(ds, blocks, x, k)
        torch.cuda.synchronize()
        assert (L.matvec.class_launches["w32"], L.matvec.shared_launches["w32"]) == (1, int(k > 1))
        y_ref = ldu.matvec(ds.plan, blocks, x, k)
        mag = ldu.matvec(ds.plan, blocks.abs(), x.abs(), k)
        assert bool(((y - y_ref).abs() <= 1e-5 * mag + 1e-30).all())
        width = torch.as_tensor(np.asarray(sched.node_width), device="cuda")
        pad = torch.arange(sched.width, device="cuda") >= width[:, None]
        assert torch.equal(y[:, pad], x[:, pad])


# the model whose schedule stands for each width class
CLASS_MODELS = {"quadruped": dict(timestep=0.05), "humanoid": {}, "block": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "dup", "comb"])
@pytest.mark.parametrize("name", list(CLASS_MODELS))
def test_block_lu_bitwise_on_cuda(name, kind):
    """Each width class's factorize (quadruped W=14, humanoid W=22, block
    W=70) on chip_smoke.swap_blocks, each node's block factored as made
    (edge blocks zero), 3 seeds: every block LU and PS bitwise equal to the
    plain block LU's (ldu.blu_factor: the arithmetic row swap and the fused
    Schur update), and no smallest pivot at the floor where the plain one's
    is not.  The dup blocks' pivots cancel to exactly 0, and the floor,
    without the arithmetic swap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke as C

    sched = build_schedule(models.get_mechanism(name, device="cpu", **CLASS_MODELS[name]).topo)
    ds = L.DeviceSchedule(sched, "cuda")
    for seed in range(3):
        fact = L.factorize(ds, C.isolated_blocks(sched, kind, seed, 8, "cuda"))
        res = C.lu_vs_plain(sched, *fact)
        assert res["differ"] == 0 and res["floored"] == 0, res


@pytest.mark.cuda
def test_block_lu_bitwise_quadruped_kkt_on_cuda():
    """The W <= 16 factorize on the quadruped KKT (float32, B=4): each
    block LU and PS bitwise equal to the plain block LU's of the block the
    kernel factored (its Schur-updated diagonal block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke as C

    sched, blocks, _ = quadruped_kkt(torch.float32, "cuda")
    res = C.lu_vs_plain(sched, *L.factorize(L.DeviceSchedule(sched, "cuda"), blocks))
    assert res["blocks"] == 4 * sched.n_nodes and res["differ"] == 0, res


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_w33_72_solve_matvec_on_cuda(k):
    """The 33..72 solve (solve_real's design, block's 70-wide node
    substituted a thread a row, a barrier a row) unrefined, and the 33..72
    matvec (matvec_real), with k right-hand sides a factorization, against
    the plain versions on the same factors and blocks, block at an odd B,
    float32 and float64: the solve to max(2e-5, 4x the plain float32
    solve's own error against float64) of its scale (float64: 1e-12), the
    matvec within 1e-5·Σ|E||x|, each limit failed by a control off by
    ~1e-3 (chip_smoke.control); the pad of a solution is the right-hand
    side's and of a product the vector's, exactly; both kernels of the
    w72 class, with k > 1 counted in ``shared_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke as C

    lanes = 3
    for dtype in (torch.float32, torch.float64):
        sched, blocks, r = model_kkt("block", dtype, "cuda", lanes)
        ds = L.DeviceSchedule(sched, "cuda")
        fact = L.factorize(ds, blocks)
        noise = np.random.default_rng(k).standard_normal((lanes * k, r.shape[-1]))
        flat = r.repeat_interleave(k, 0) + torch.as_tensor(noise, dtype=dtype, device="cuda")
        b = L.flat_to_nodes(ds.plan, flat).contiguous()
        L.reset_launches()
        x = L.solve(ds, fact, b, k)
        y = L.matvec(ds, blocks, b, k)
        torch.cuda.synchronize()
        assert (L.solve.class_launches["w72"], L.matvec.class_launches["w72"]) == (1, 1)
        assert (L.solve.shared_launches["w72"], L.matvec.shared_launches["w72"]) == (k > 1,) * 2
        x_ref = ldu.solve(ds.plan, fact, b, k)
        scale = float(x_ref.abs().max())
        lim = 1e-12
        if dtype == torch.float32:
            x_64 = ldu.solve(ds.plan, [f.double() for f in fact], b.double(), k)
            lim = max(2e-5, 4 * float((x_ref.double() - x_64).abs().max()) / scale)
        rel = lambda a: float((a - x_ref).abs().max()) / scale
        assert rel(x) < lim < rel(C.control(x_ref))
        y_ref = ldu.matvec(ds.plan, blocks, b, k)
        mag = ldu.matvec(ds.plan, blocks.abs(), b.abs(), k)
        within = lambda a: bool(((a - y_ref).abs() <= 1e-5 * mag + 1e-30).all())
        assert within(y) and not within(C.control(y_ref))
        width = torch.as_tensor(np.asarray(sched.node_width), device="cuda")
        pad = torch.arange(sched.width, device="cuda") >= width[:, None]
        assert torch.equal(x[:, pad], b[:, pad]) and torch.equal(y[:, pad], b[:, pad])


def _diff_loss(dtype, lanes=3, T=2):
    """The quadruped's make_diff_step_minimal on the card: (loss of inputs
    (T, lanes, nu), contact_friction and mass over T steps, the inputs,
    the params)."""
    import dataclasses

    from dojo_tpu_torch.core import SolverOptions
    from dojo_tpu_torch.gradients import make_diff_step_minimal, to_minimal

    mech = models.get_mechanism("quadruped", timestep=0.05, device="cuda").cast(dtype)
    topo, params = mech.topo, mech.params
    s0 = tensor_map(lambda a: a[None], models.initialize(mech, "quadruped"))
    y0 = to_minimal(topo, params, s0).expand(lanes, -1).contiguous()
    us = 0.1 * torch.as_tensor(np.random.default_rng(0).standard_normal(
        (T, lanes, topo.input_dim)), dtype=dtype, device="cuda")
    step = make_diff_step_minimal(topo, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30),
                                  device="cuda")

    def loss(u, fric, mass):
        p = dataclasses.replace(params, contact_friction=fric, mass=mass)
        y = y0
        for t in range(T):
            y = step(p, y, u[t])
        return (y * y).sum(-1).mean()

    return loss, us, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-8)])
def test_diff_step_reverse_matches_forward_on_cuda(dtype, tol):
    """make_diff_step on the card: the solver launches the LDU kernels, the
    grads into inputs, friction and mass are finite, and backward agrees
    with torch.func.jvp along a seeded direction (relative to Σ|gᵢdᵢ|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    loss, us, params = _diff_loss(dtype)
    u = us.clone().requires_grad_()
    fric = params.contact_friction.clone().requires_grad_()
    mass = params.mass.clone().requires_grad_()
    L.reset_launches()
    loss(u, fric, mass).backward()
    assert L.factorize.launches > 0 and L.solve.launches > 0
    for g in (u.grad, fric.grad, mass.grad):
        assert bool(torch.isfinite(g).all())
    rng = np.random.default_rng(1)
    du = torch.as_tensor(rng.standard_normal(us.shape), dtype=dtype, device="cuda")
    dfric = torch.as_tensor(rng.standard_normal(fric.shape), dtype=dtype, device="cuda")
    _, fwd = torch.func.jvp(lambda a, b: loss(a, b, params.mass), (us, params.contact_friction),
                            (du, dfric))
    terms = torch.cat([(u.grad * du).flatten(), fric.grad * dfric]).double()
    assert abs(fwd.item() - terms.sum().item()) < tol * terms.abs().sum().item()
