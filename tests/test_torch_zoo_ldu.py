"""The block LDU at the zoo's wider blocks: W=22 (humanoid's schedule, the
17..32 class of the kernels) and W=70 (block's, the 33..72 class).

float64 on the CPU: the port's plain LDU against dojo_tpu.ldu (1e-12); the
kernels' order of work (csrc/ldu.cu) run as plain PyTorch against ldu.py
(1e-12); numpy models of the two new classes' block LU against
ldu.blu_factor on blocks built to tie (exact); the kernels' schedule lists;
each class's shared-memory bytes a lane takes, as numbers, and the
ValueError of a lane that does not fit.  The kernels themselves run only
on a card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import model_kkt
from test_torch_ldu_order import _factorize_kernel_order, _solve_kernel_order

from dojo_tpu import ldu as jldu
from dojo_tpu_torch import ldu, ldu_cuda as L

WIDE = ("humanoid", "block")  # W = 22 and W = 70


@pytest.fixture(scope="module", params=WIDE)
def kkt64(request):
    sched, blocks, r = model_kkt(request.param, torch.float64)
    _, factorize, solve, matvec = jldu.make_ldu(sched)
    jb, jr = jnp.asarray(blocks.numpy()), jnp.asarray(r.numpy())
    fact = jax.jit(jax.vmap(factorize))(jb)
    x = jax.jit(jax.vmap(solve))(fact, jr)
    y = jax.jit(jax.vmap(matvec))(jb, jr)
    ref = [np.asarray(a) for a in fact], np.asarray(x), np.asarray(y)
    return request.param, sched, blocks, r, ref


def test_plain_ldu_matches_dojo_tpu_f64(kkt64):
    """Factored blocks, solve and matvec to 1e-12; L·U = PS·D for every
    node (LU and PS themselves may differ where pivot magnitudes tie, see
    tests/test_torch_ldu.py)."""
    name, sched, blocks, r, (fact_r, x_r, y_r) = kkt64
    assert sched.width == {"humanoid": 22, "block": 70}[name]
    _, factorize, solve, matvec = ldu.make_ldu(sched, "cpu")
    fb, LU, PS = factorize(blocks)
    np.testing.assert_allclose(fb.numpy(), fact_r[0], rtol=0, atol=1e-12)
    lower = torch.tril(LU, -1) + torch.eye(sched.width, dtype=LU.dtype)
    np.testing.assert_allclose((lower @ torch.triu(LU)).numpy(),
                               (PS @ fb[:, : sched.n_nodes]).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(solve((fb, LU, PS), r).numpy(), x_r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(matvec(blocks, r).numpy(), y_r, rtol=0, atol=1e-12)


def test_kernel_order_matches_plain_f64(kkt64):
    """Both new classes run factorize and solve in the order of the W <= 16
    kernels (pairs once, targets over their updates in list order; the
    solve pulls each node's edges in list order); here that order on the
    zoo's schedules against ldu.py, 1e-12."""
    _, sched, blocks, r, _ = kkt64
    plan = ldu.LduPlan(sched, "cpu")
    a = L._csr(sched)
    ref = ldu.factorize(plan, blocks)
    for got, want in zip(_factorize_kernel_order(sched, a, blocks), ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    rhs = ldu.flat_to_nodes(plan, r)
    np.testing.assert_allclose(_solve_kernel_order(sched, a, ref, rhs).numpy(),
                               ldu.solve(plan, ref, rhs).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["snake", "hopper", "walker", "humanoid", "block"])
def test_schedule_lists(name):
    """_csr takes the zoo's schedules: every Schur update once under its
    target, each level's pairs distinct, the solve's edges once under the
    node they update, and the tile index of each node in its level."""
    sched = model_kkt(name, torch.float64, lanes=1)[0]
    a = L._csr(sched)
    n_upd = sum(len(lv.upd_tgt) for lv in sched.levels)
    assert sorted(a["tgt_upd"].tolist()) == list(range(n_upd))
    for k, lv in enumerate(sched.levels):
        p0, p1 = a["pair_ptr"][k], a["pair_ptr"][k + 1]
        pairs = list(zip(a["pair_node"][p0:p1].tolist(), a["pair_slot"][p0:p1].tolist()))
        assert len(pairs) == len(set(pairs))
        assert a["node_pos"][lv.nodes].tolist() == list(range(len(lv.nodes)))
    n_fwd = sum(len(lv.fwd_a) for lv in sched.levels)
    n_bwd = sum(len(lv.bwd_i) for lv in sched.levels)
    assert sorted(a["fin_e"].tolist()) == list(range(n_fwd))
    assert sorted(a["bin_e"].tolist()) == list(range(n_bwd))


def _tied_blocks(seed, n, W, count=6):
    """Blocks [[D, 0], [0, I]] whose entries come from a few values, so
    rows scale to exact ±1s and pivot candidates tie."""
    rng = np.random.default_rng(seed)
    D = np.tile(np.eye(W), (count, 1, 1))
    D[:, :n, :n] = rng.choice([-2.0, -1.0, 0.0, 0.5, 1.0, 2.0], size=(count, n, n))
    D[:, :n, :n] += 4 * np.eye(n) * rng.integers(0, 2, size=(count, 1, 1))
    return D


def _floor(a):
    return a if abs(a) > 1e-30 else (-1e-30 if a < 0 else 1e-30)


def _register_lu(D, n, TW, group=32):
    """block_lu of the 17..32 class in numpy: the block padded to a TW x TW
    tile ([[D, 0], [0, I]]), a group of 32 lanes of which lanes r >= TW hold
    zero rows, lazy pivoting over positions k..n-1 (key pos * group + r,
    largest value, then lowest key), the pivot floored when taken."""
    W = D.shape[0]
    m = np.zeros((group, TW))
    m[:W, :W] = D
    m[W:TW, W:TW] = np.eye(TW - W)
    rmax = np.abs(m).max(axis=1)
    sc = np.where(rmax > 0, 1.0 / np.where(rmax > 0, rmax, 1.0), 1.0)
    m *= sc[:, None]
    pos = np.arange(group)
    for k in range(n):
        cand = [(abs(m[r, k]), -(pos[r] * group + r), r) for r in range(group) if k <= pos[r] < n]
        key = -max(cand)[1]
        pl, ppos = key % group, key // group
        a = _floor(m[pl, k])
        for r in range(group):
            pos[r] = k if r == pl else (ppos if pos[r] == k else pos[r])
            if pos[r] > k:
                mult = m[r, k] / a
                m[r, k + 1 :] -= mult * m[pl, k + 1 :]
                m[r, k] = mult
        m[pl, k] = a
    assert not m[TW:].any()  # the lanes past the tile stay zero rows
    LU, PS = np.empty((TW, TW)), np.zeros((TW, TW))
    LU[pos[:TW]] = m[:TW]
    PS[pos[:TW], np.arange(TW)] = sc[:TW]
    return LU[:W, :W], PS[:W, :W]


def _wide_lu(D, n):
    """fact_wide's block LU (csrc/ldu.cu wide_lu) in numpy: a thread per row
    of W rounded up to 32 threads, rows in place; per pivot each warp's
    winner (largest value, on a tie the lowest key pos * 128 + r), then the
    warps' winners taken in order; the pivot row keeps its unfloored entry
    and each pivot is floored when LU is stored."""
    W = D.shape[0]
    nt = -(-W // 32) * 32
    m = D.copy()
    rmax = np.abs(m).max(axis=1)
    sc = np.where(rmax > 0, 1.0 / np.where(rmax > 0, rmax, 1.0), 1.0)
    m *= sc[:, None]
    pos = np.arange(nt)
    better = lambda o, b: o[0] > b[0] or (o[0] == b[0] and o[1] < b[1])
    for k in range(n):
        cand = [((abs(m[r, k]) if r < W and k <= pos[r] < n else -1.0), pos[r] * 128 + r)
                for r in range(nt)]
        winners = []
        for w in range(nt // 32):
            best = cand[32 * w]
            for c in cand[32 * w + 1 : 32 * w + 32]:
                best = c if better(c, best) else best
            winners.append(best)
        best = winners[0]
        for c in winners[1:]:
            best = c if better(c, best) else best
        pl, ppos = best[1] % 128, best[1] // 128
        a = _floor(m[pl, k])
        for r in range(W):
            pos[r] = k if r == pl else (ppos if pos[r] == k else pos[r])
            if pos[r] > k:
                mult = m[r, k] / a
                m[r, k + 1 :] -= mult * m[pl, k + 1 :]
                m[r, k] = mult
    for r in range(W):
        if pos[r] < n:
            m[r, pos[r]] = _floor(m[r, pos[r]])
    LU, PS = np.empty_like(m), np.zeros_like(m)
    LU[pos[:W]] = m
    PS[pos[:W], np.arange(W)] = sc
    return LU, PS


@pytest.mark.parametrize("W, n, TW", [(22, 19, 24), (22, 22, 24), (29, 25, 32)])
def test_register_class_lu_matches_blu_factor(W, n, TW):
    """The 17..32 class's block LU at its padded tile against ldu.blu_factor
    (exact), pivot ties included."""
    D = _tied_blocks(W, n, W)
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    for b in range(D.shape[0]):
        LU, PS = _register_lu(D[b], n, TW)
        np.testing.assert_array_equal(LU, lu[b].numpy())
        np.testing.assert_array_equal(PS, ps[b].numpy())


@pytest.mark.parametrize("W, n", [(70, 64), (70, 70), (38, 33)])
def test_wide_class_lu_matches_blu_factor(W, n):
    """The 33..72 class's block LU against ldu.blu_factor (exact), pivot
    ties included."""
    D = _tied_blocks(W + n, n, W, count=3)
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    for b in range(D.shape[0]):
        LU, PS = _wide_lu(D[b], n)
        np.testing.assert_array_equal(LU, lu[b].numpy())
        np.testing.assert_array_equal(PS, ps[b].numpy())


def test_width_classes():
    """Each width's class and padded tile (csrc/ldu.cu ldu_tile)."""
    assert [L.width_class(W) for W in (1, 16, 17, 32, 33, 72)] == [
        "w16", "w16", "w32", "w32", "w72", "w72"]
    assert [L.tile_width(W) for W in (6, 14, 16, 17, 22, 24, 25, 32, 33, 70, 72)] == [
        16, 16, 16, 24, 24, 24, 32, 32, 33, 70, 72]
    with pytest.raises(ValueError, match="MAXW"):
        L.tile_width(73)


# one lane's shared memory in bytes: (factorize, solve); None where the
# lane does not fit the 232,448 bytes a CTA may have
SMEM = {
    ("humanoid", torch.float32): (226416, 222928),
    ("walker", torch.float32): (117192, 116776),
    ("block", torch.float32): (118696, 82232),
    ("snake", torch.float32): (30964, 28308),
    ("humanoid", torch.float64): (None, None),
    ("walker", torch.float64): (232072, 230088),
    ("block", torch.float64): (None, 163712),
}


@pytest.mark.parametrize("name, dtype", list(SMEM), ids=[f"{n}-{str(d)[6:]}" for n, d in SMEM])
def test_shared_memory_bytes(name, dtype):
    """A lane's shared memory in each class (humanoid fits only at tiles
    padded to 24), and the ValueError, with the bytes, of a lane over the
    limit: such a lane never reaches a kernel, and never the plain version
    on a card."""
    sched = model_kkt(name, torch.float64, lanes=1)[0]
    for kernel, want in zip(("factorize", "solve"), SMEM[name, dtype]):
        if want is None:
            with pytest.raises(ValueError, match=r"one lane needs \d+ bytes of shared memory"):
                L.smem_layout(sched, kernel, dtype)
        else:
            layout = L.smem_layout(sched, kernel, dtype)
            assert layout["bytes"] == want <= L.SMEM_LIMIT
            fields = [f for f, _ in L._LAYOUT_STRUCTS[kernel]._fields_]
            assert list(layout) == fields
            assert [layout[f] for f in fields] == sorted(layout.values())


def test_wrappers_take_plain_version_on_cpu_at_any_width():
    """On the CPU the wrappers take ldu.py at W=70 and count no launch."""
    sched, blocks, r = model_kkt("block", torch.float32, lanes=2)
    ds = L.DeviceSchedule(sched, "cpu")
    L.reset_launches()
    fact = L.factorize(ds, blocks)
    for a, b in zip(fact, ldu.factorize(ds.plan, blocks)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    b = L.flat_to_nodes(ds.plan, r)
    torch.testing.assert_close(L.solve(ds, fact, b), ldu.solve(ds.plan, fact, b), rtol=0, atol=0)
    torch.testing.assert_close(L.matvec(ds, blocks, b), ldu.matvec(ds.plan, blocks, b),
                               rtol=0, atol=0)
    assert (L.factorize.launches, L.solve.launches, L.matvec.launches) == (0, 0, 0)
    assert all(not any(fn.class_launches.values()) for fn in (L.factorize, L.solve, L.matvec))
