"""The port's block LDU (plain versions of the CUDA kernels) against
dojo_tpu.ldu on the quadruped KKT, and the device dispatch of the kernel
wrappers.

float64: factorize / solve / matvec to 1e-10.  float32: the checks of
tests/test_pallas_ldu.py with its tolerances (factored blocks atol 5e-3,
solve + one refinement sweep within 2e-5 of scale, relative residual
below 1e-4).  The KKT is built by the port at a perturbed initial point,
as tests/test_pallas_ldu.py builds it; the same block array goes to both
packages.  The kernels themselves run only on a CUDA device: the test
marked ``cuda`` holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import quadruped_kkt

from dojo_tpu import ldu as jldu
from dojo_tpu_torch import ldu, ldu_cuda as L, models
from dojo_tpu_torch.simulate import make_step

@pytest.fixture(scope="module")
def kkt64():
    return quadruped_kkt(torch.float64)


@pytest.fixture(scope="module")
def kkt32():
    return quadruped_kkt(torch.float32)


def _jax_ldu(sched, blocks, r):
    """dojo_tpu's jnp LDU (the path _pallas_ok selects on the CPU), vmapped.
    It reads only the schedule's numpy fields, which the port's Schedule
    holds identically (tests/test_torch_model.py)."""
    _, factorize, solve, matvec = jldu.make_ldu(sched)
    jb, jr = jnp.asarray(blocks.numpy()), jnp.asarray(r.numpy())
    fact = jax.jit(jax.vmap(factorize))(jb)
    solve_b, matvec_b = jax.jit(jax.vmap(solve)), jax.jit(jax.vmap(matvec))
    x = solve_b(fact, jr)
    x1 = x + solve_b(fact, jr - matvec_b(jb, x))
    return [np.asarray(a) for a in fact], np.asarray(x), np.asarray(x1), np.asarray(matvec_b(jb, jr))


@pytest.fixture(scope="module")
def ref64(kkt64):
    return _jax_ldu(*kkt64)


def test_factorize_matches_f64(kkt64, ref64):
    """Factored blocks to 1e-10.  LU/PS differ from dojo_tpu's where pivot
    magnitudes tie (row scaling makes many entries exactly 1, and dojo_tpu
    swaps rows arithmetically, T + (Tp − Tk), which moves ties by an ulp),
    so for them the contract is the factorization identity L·U = PS·D of
    every node, and the solves (test_solve_matches_f64)."""
    sched, blocks, _ = kkt64
    fb, LU, PS = ldu.factorize(ldu.LduPlan(sched, "cpu"), blocks)
    np.testing.assert_allclose(fb.numpy(), ref64[0][0], rtol=0, atol=1e-10)
    D = fb[:, : sched.n_nodes]  # diagonal slots 0..N-1 hold each node's D
    lower = torch.tril(LU, -1) + torch.eye(sched.width, dtype=LU.dtype)
    np.testing.assert_allclose((lower @ torch.triu(LU)).numpy(), (PS @ D).numpy(),
                               rtol=0, atol=1e-12)


def test_solve_matches_f64(kkt64, ref64):
    sched, blocks, r = kkt64
    _, factorize, solve, matvec = ldu.make_ldu(sched, "cpu")
    fact = factorize(blocks)
    x = solve(fact, r)
    np.testing.assert_allclose(x.numpy(), ref64[1], rtol=0, atol=1e-10)
    x1 = x + solve(fact, r - matvec(blocks, x))
    np.testing.assert_allclose(x1.numpy(), ref64[2], rtol=0, atol=1e-10)
    res = r - matvec(blocks, x)
    assert float((res.norm(dim=-1) / r.norm(dim=-1)).max()) < 1e-10


def test_matvec_matches_f64(kkt64, ref64):
    sched, blocks, r = kkt64
    y = ldu.make_ldu(sched, "cpu")[3](blocks, r)
    np.testing.assert_allclose(y.numpy(), ref64[3], rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blu_factor_solve_match_f64(seed):
    """In-block pivoted LU on random blocks with pad dims (n < W)."""
    rng = np.random.default_rng(seed)
    n, W = 9, 14
    D = np.tile(np.eye(W), (5, 1, 1))
    D[:, :n, :n] = rng.standard_normal((5, n, n)) * np.logspace(-3, 3, n)[:, None]
    rhs = rng.standard_normal((5, W, 3))
    lu_r, ps_r = jldu.blu_factor(jnp.asarray(D), n)
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    np.testing.assert_allclose(lu.numpy(), np.asarray(lu_r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ps.numpy(), np.asarray(ps_r), rtol=0, atol=1e-12)
    x = ldu.blu_solve(lu, ps, torch.as_tensor(rhs))
    np.testing.assert_allclose(x.numpy(), np.asarray(jldu.blu_solve(lu_r, ps_r, jnp.asarray(rhs))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(D @ x.numpy(), rhs, atol=1e-8)


def test_float32_matches_reference(kkt32):
    """tests/test_pallas_ldu.py's contract, port plain f32 vs dojo_tpu f32."""
    sched, blocks, r = kkt32
    fact_r, _, x_ref, _ = _jax_ldu(sched, blocks, r)
    ds = L.DeviceSchedule(sched, "cpu")
    fact = L.factorize(ds, blocks)
    np.testing.assert_allclose(fact[0].numpy(), fact_r[0], atol=5e-3)
    x = L.nodes_to_flat(ds.plan, L.solve_refine(ds, blocks, fact, L.flat_to_nodes(ds.plan, r), 1), 356)
    scale = float(np.abs(x_ref).max())
    np.testing.assert_allclose(x.numpy() / scale, x_ref / scale, atol=2e-5)
    res = r - ldu.make_ldu(sched, "cpu")[3](blocks, x)
    assert float((res.norm(dim=-1) / r.norm(dim=-1)).max()) < 1e-4


def test_wrappers_take_plain_version_on_cpu(kkt32):
    """A CPU tensor takes ldu.py's plain version; no kernel launch is counted."""
    sched, blocks, r = kkt32
    ds = L.DeviceSchedule(sched, "cpu")
    L.reset_launches()
    fact = L.factorize(ds, blocks)
    ref = ldu.factorize(ds.plan, blocks)
    for a, b in zip(fact, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    b = L.flat_to_nodes(ds.plan, r)
    torch.testing.assert_close(L.solve(ds, fact, b), ldu.solve(ds.plan, ref, b), rtol=0, atol=0)
    torch.testing.assert_close(L.matvec(ds, blocks, b), ldu.matvec(ds.plan, blocks, b), rtol=0, atol=0)
    assert (L.factorize.launches, L.solve.launches, L.matvec.launches) == (0, 0, 0)


def test_wrappers_reject_other_devices(kkt32):
    sched, blocks, _ = kkt32
    ds = L.DeviceSchedule(sched, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        L.factorize(ds, blocks.to("meta"))


def test_schedule_csr_layout(kkt32):
    """The kernels' CSR lists hold the schedule's lists in level order."""
    sched = kkt32[0]
    a = L._csr(sched)
    assert list(a["level_ptr"]) == list(np.cumsum([0] + [len(lv.nodes) for lv in sched.levels]))
    assert a["upd_ai"].tolist() == [int(s) for lv in sched.levels for s in lv.upd_ai]
    assert a["fwd_ai"].tolist() == [int(s) for lv in sched.levels for s in lv.fwd_ai]
    assert a["bwd_ia"].tolist() == [int(s) for lv in sched.levels for s in lv.bwd_ia]
    rows = {s: ab[0] for ab, s in sched.slot.items()}
    for nd in range(sched.n_nodes):
        slots = a["row_slot"][a["row_ptr"][nd] : a["row_ptr"][nd + 1]]
        assert sorted(slots.tolist()) == slots.tolist()
        assert all(rows[int(s)] == nd for s in slots)
    assert all(v.dtype == np.int32 for v in a.values())


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """device=None means CUDA: with no card the entry points raise rather
    than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.get_mechanism("quadruped", timestep=0.05)
    topo = models.get_mechanism("quadruped", timestep=0.05, device="cpu").topo
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_step(topo)
