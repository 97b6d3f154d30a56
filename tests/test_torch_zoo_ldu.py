"""The block LDU at the zoo's wider blocks: W=22 (humanoid's schedule, the
17..32 class of the kernels) and W=70 (block's, the 33..72 class).

float64 on the CPU: the port's plain LDU against dojo_tpu.ldu (1e-12); the
kernels' order of work (csrc/ldu.cu) run as plain PyTorch against ldu.py
(1e-12); numpy models of the two new classes' block LU against
ldu.blu_factor on blocks built to tie (exact; the 17..32 class at each
node's real width); the kernels' schedule lists;
each class's shared-memory bytes a lane takes, as numbers, and the
ValueError of a lane that does not fit.  The kernels themselves run only
on a card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import model_kkt
from test_torch_ldu_order import _factorize_kernel_order, _solve_kernel_order, _swap_rows

from dojo_tpu import ldu as jldu
from dojo_tpu_torch import ldu, ldu_cuda as L, models
from dojo_tpu_torch.graph import build_schedule

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


def _schedule(name):
    """A zoo model's elimination schedule (no KKT assembled)."""
    return build_schedule(models.get_mechanism(name, device="cpu").topo)


@pytest.mark.parametrize("name", ["snake", "hopper", "walker", "humanoid", "block"])
def test_schedule_lists(name):
    """_csr takes the zoo's schedules: every Schur update once under its
    target, each level's pairs distinct, the solve's edges once under the
    node they update, and the tile index of each node in its level."""
    sched = _schedule(name)
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


def _register_lu(D, n, TW, group, n_loop):
    """real_lu of the 17..32 class in numpy: the node's real n x n block
    ([:n, :n] of D) in a tile of TW ([[D, 0], [0, I]]), a group of `group`
    lanes of which lanes r >= TW hold zero rows, lazy pivoting over
    positions k..n_loop-1 (n_loop >= n: the widest node of the warp; the
    pivots past n are the pad's identity rows) with key pos * group + r
    (largest value, then lowest key) and the arithmetic row swap, the pivot
    floored when taken.  Returns the real n x n LU and PS, after checking
    that the tile's pad is identity."""
    m = np.zeros((group, TW))
    m[:n, :n] = D[:n, :n]
    m[n:TW, n:TW] = np.eye(TW - n)
    rmax = np.abs(m).max(axis=1)
    sc = np.where(rmax > 0, 1.0 / np.where(rmax > 0, rmax, 1.0), 1.0)
    m *= sc[:, None]
    pos = np.arange(group)
    for k in range(n_loop):
        cand = [(abs(m[r, k]), -(pos[r] * group + r), r) for r in range(group)
                if k <= pos[r] < n_loop]
        key = -max(cand)[1]
        pl, ppos = key % group, key // group
        _swap_rows(m, np.flatnonzero(pos == k)[0], pl)
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
    np.testing.assert_array_equal(LU[n:, n:], np.eye(TW - n))
    assert not LU[:n, n:].any() and not LU[n:, :n].any()
    np.testing.assert_array_equal(PS[n:, n:], np.eye(TW - n))
    return LU[:n, :n], PS[:n, :n]


def _wide_lu(D, n, warps=8):
    """fact_wide's block LU of a node wider than 32 (csrc/ldu.cu cta_lu) in
    numpy, on the node's real n x n block, entry by entry as the kernel
    computes it (with warps=3, csrc/ldu_lane.cu group_lu's): each of the
    warps' candidate for pivot k, its rows w, w + warps, ... >= k scanned
    from the last, a tie keeping the lower row; the
    pivot the largest candidate, on a tie the lowest row; rows k and p
    formed arithmetically (Tk + (Tp - Tk) and Tp + (Tk - Tp)) in every
    column, their multipliers too, the pivot floored, each multiplier a
    quotient, each trailing entry m - f p (the product rounded apart,
    float64) once a pivot; PS's rows swapped.  Returns the n x n LU and
    PS."""
    m = D[:n, :n].copy()
    rmax = np.abs(m).max(axis=1)
    sc = np.where(rmax > 0, 1.0 / np.where(rmax > 0, rmax, 1.0), 1.0)
    m *= sc[:, None]
    prow, psc = np.arange(n), sc.copy()
    for k in range(n):
        cands = []
        for w in range(warps):
            v, key = -1.0, w
            for i in reversed(range(w, n, warps)):
                if i >= k and abs(m[i, k]) >= v:
                    v, key = abs(m[i, k]), i
            cands.append((v, -key))
        p = -max(cands)[1]
        tk, tp = m[k].copy(), m[p].copy()
        if p != k:
            m[k], m[p] = tk + (tp - tk), tp + (tk - tp)
            prow[[k, p]], psc[[k, p]] = prow[[p, k]], psc[[p, k]]
        a = _floor(m[k, k])
        m[k, k] = a
        for i in range(k + 1, n):
            f = m[i, k] / a
            m[i, k + 1 :] = m[i, k + 1 :] - f * m[k, k + 1 :]
            m[i, k] = f
    PS = np.zeros((n, n))
    PS[np.arange(n), prow] = psc
    return m, PS


def _check_register_lu(W, n, TW, n_loop):
    D = _tied_blocks(W, n, W)
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    eye = np.eye(W)
    for b in range(D.shape[0]):
        LU, PS = _register_lu(D[b], n, TW, TW if TW <= 16 else 32, n_loop)
        np.testing.assert_array_equal(LU, lu[b, :n, :n].numpy())
        np.testing.assert_array_equal(PS, ps[b, :n, :n].numpy())
        np.testing.assert_array_equal(lu[b, n:, n:].numpy(), eye[n:, n:])


@pytest.mark.parametrize("W, n, TW", [(22, 6, 8), (22, 14, 16), (22, 19, 24), (22, 22, 24),
                                      (29, 25, 32)])
def test_register_class_lu_matches_blu_factor(W, n, TW):
    """The 17..32 class's block LU of a node's real n x n block at its
    level's tile (groups of 8 or 16 lanes, or a warp) against
    ldu.blu_factor of the W x W block at width n on the real part (exact),
    pivot ties included; the pad is identity in both."""
    _check_register_lu(W, n, TW, n)


@pytest.mark.parametrize("n, n_loop", [(6, 22), (14, 22)])
def test_register_class_lu_pad_pivots(n, n_loop):
    """A node narrower than its warp's widest (humanoid's 6-wide nodes at
    level 0, tile 24) pivots on to n_loop through its pad's identity rows:
    its real part is still ldu.blu_factor's at width n, exactly."""
    _check_register_lu(22, n, 24, n_loop)


@pytest.mark.parametrize("W, n", [(70, 64), (70, 70), (38, 33), (72, 72)])
def test_wide_class_lu_matches_blu_factor(W, n):
    """The 33..72 class's block LU of a node wider than 32, at its real
    width n, against ldu.blu_factor of the W x W block at width n on the
    real part (exact), pivot ties included; the pad of ldu.blu_factor's is
    identity."""
    D = _tied_blocks(W + n, n, W, count=3)
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    eye = np.eye(W)
    for b in range(D.shape[0]):
        LU, PS = _wide_lu(D[b], n)
        np.testing.assert_array_equal(LU, lu[b, :n, :n].numpy())
        np.testing.assert_array_equal(PS, ps[b, :n, :n].numpy())
        for t in (lu, ps):
            np.testing.assert_array_equal(t[b, n:, n:].numpy(), eye[n:, n:])
            assert not t[b, :n, n:].any() and not t[b, n:, :n].any()


def test_width_classes():
    """Each width's class and padded tile (csrc/ldu.cu ldu_tile); the 17..32
    class has none (each level takes its own)."""
    assert [L.width_class(W) for W in (1, 16, 17, 32, 33, 72)] == [
        "w16", "w16", "w32", "w32", "w72", "w72"]
    assert [L.tile_width(W) for W in (6, 14, 16, 33, 70, 72)] == [16, 16, 16, 33, 70, 72]
    for W in (17, 22, 24, 25, 32):
        with pytest.raises(ValueError, match="no single tile"):
            L.tile_width(W)
    with pytest.raises(ValueError, match="MAXW"):
        L.tile_width(73)


# one lane's shared memory in bytes: (factorize, solve); None where the
# lane does not fit the 232,448 bytes a CTA may have
SMEM = {
    ("humanoid", torch.float32): (94672, 97504),
    ("walker", torch.float32): (102208, 101888),
    ("block", torch.float32): (104400, 66992),
    ("snake", torch.float32): (31312, 24896),
    ("hopper", torch.float32): (55264, 55552),
    ("twister", torch.float32): (85520, 73504),
    ("humanoid", torch.float64): (177648, 183664),
    ("walker", torch.float64): (194736, 194224),
    ("snake", torch.float64): (60192, 47520),
    ("hopper", torch.float64): (105152, 105792),
    ("block", torch.float64): (207920, 133120),
}
# block's matvec CTA (33..72: the 17..32 class's matvec_real) at k = 1, 3
# and 54: (vectors a CTA takes, its shared memory in bytes)
BLOCK_MATVEC_SMEM = {
    torch.float32: {1: (1, 43220), 3: (3, 44340), 54: (54, 72900)},
    torch.float64: {1: (1, 86340), 3: (3, 88580), 54: (27, 115460)},
}


@pytest.mark.parametrize("name, dtype", list(SMEM), ids=[f"{n}-{str(d)[6:]}" for n, d in SMEM])
def test_shared_memory_bytes(name, dtype):
    """A lane's shared memory in each class (17..72 at real widths, so that
    humanoid fits in float64 too: its padded lane took 448,432 bytes; the
    33..72 factorize too, so that block's float64 lane fits: it took
    over 232,448; block's solve took 82,588 / 164,068 bytes with W x W
    blocks; every real-width array 16-byte aligned for its cp.async
    copies; block's matvec CTA as BLOCK_MATVEC_SMEM says, under the limit),
    and the ValueError, with the bytes, of a lane over the limit: such a
    lane never reaches a kernel, and never the plain version on a card."""
    sched = _schedule(name)
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
            if L.width_class(sched.width) != "w16":
                assert all(layout[f] % 16 == 0 for f in fields)
    if name == "block":
        elem = torch.empty((), dtype=dtype).element_size()
        staged = int(L._real_widths(sched)["slot_off"][-1]) * elem
        for k, (kc, nbytes) in BLOCK_MATVEC_SMEM[dtype].items():
            assert L.shared_chunk(sched, "matvec", dtype, k) == kc
            layout = L.smem_layout(sched, "matvec", dtype, kc=kc)
            assert layout["x"] == staged and staged % 16 == 0 and layout["idx"] % 16 == 0
            assert layout["bytes"] == nbytes <= L.SMEM_LIMIT


# the 17..32 matvec's CTA: {k: (vectors a CTA takes, its shared memory in
# bytes)}: the lane's real rows of every slot, W wide, the vectors, then
# the index arrays the kernel reads
MATVEC_SMEM = {
    ("humanoid", torch.float32): {1: (1, 65460), 3: (3, 70036), 54: (18, 104356)},
    ("walker", torch.float32): {1: (1, 70532), 3: (3, 72996), 54: (27, 102564)},
    ("humanoid", torch.float64): {1: (1, 128996), 3: (3, 138148), 54: (18, 206788)},
    ("walker", torch.float64): {1: (1, 140052), 3: (3, 144980), 54: (27, 204116)},
}


@pytest.mark.parametrize("name, dtype", list(MATVEC_SMEM),
                         ids=[f"{n}-{str(d)[6:]}" for n, d in MATVEC_SMEM])
def test_matvec_w17_32_shared_memory_bytes(name, dtype):
    """The 17..32 matvec stages each slot's n_a real rows, W wide, at its
    place (slot_off, 16-byte aligned), then kc of a lane's k vectors (N x W
    each, 16-byte aligned) and the seven index arrays it reads (row_ptr,
    row_slot, slot_b, slot_off, slot_rc, node_vec, node_w): as many
    vectors as fit two CTAs an SM (228 KB less 1 KB a CTA, halved) where
    one vector does (float32), else one CTA an SM, spread evenly over the
    fewest CTAs."""
    sched = _schedule(name)
    elem = torch.empty((), dtype=dtype).element_size()
    N, S = sched.n_nodes, sched.n_slots
    staged = -(-int(L._real_widths(sched)["slot_off"][-1]) * elem // 16) * 16
    idx = (4 * S + 3 * N + 3) * 4
    per_vec = N * sched.width * elem
    for k, (kc, nbytes) in MATVEC_SMEM[name, dtype].items():
        assert L.shared_chunk(sched, "matvec", dtype, k) == kc
        layout = L.smem_layout(sched, "matvec", dtype, kc=kc)
        assert layout["x"] == staged and layout["x"] % 16 == 0
        assert layout["idx"] == staged + kc * per_vec
        assert layout["bytes"] == nbytes == staged + kc * per_vec + idx
        two = staged + per_vec + idx <= L.SMEM_HALF
        assert two == (dtype == torch.float32)
        assert nbytes <= (L.SMEM_HALF if two else L.SMEM_LIMIT)


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
