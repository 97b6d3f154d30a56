"""The kernels' derived schedule lists (ldu_cuda._csr) and the order of
work they give the CUDA factorize and solve, checked on the CPU.

The factorize kernel computes X = D_i⁻¹E_{i,b} once per distinct (i, b)
pair of a level, then reduces each target block over its updates in list
order; the solve kernel pulls, for each node, the contributions of the
edges that update it, in list order.  Here both orders run as plain
PyTorch on the quadruped KKT (float64, B=4) and are held to ldu.py's
factorize and solve to 1e-12 (summation order only).  The shared-memory
layout of the kernels is checked too.  Nothing here needs a card.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_cuda import quadruped_kkt

from dojo_tpu_torch import ldu, ldu_cuda as L


@pytest.fixture(scope="module")
def kkt():
    sched, blocks, r = quadruped_kkt(torch.float64)
    return sched, blocks, r, L._csr(sched)


def _cat(sched, field):
    """The schedule's per-level list ``field``, concatenated over levels."""
    return np.concatenate([getattr(lv, field) for lv in sched.levels])


def _level_updates(sched):
    """Per level: the global indices of its Schur updates."""
    ptr = np.cumsum([0] + [len(lv.upd_tgt) for lv in sched.levels])
    return [range(ptr[k], ptr[k + 1]) for k in range(len(sched.levels))]


def test_csr_holds_the_kernel_arrays(kkt):
    """_csr gives exactly the arrays struct Sched points at, as int32."""
    a = kkt[3]
    assert set(a) == set(L._ARRAYS)
    assert all(v.dtype == np.int32 for v in a.values())


def test_pairs_describe_the_updates(kkt):
    """Each level's pairs are the distinct (i, b) of its updates, and each
    update's pair index points at its own (i, b)."""
    sched, _, _, a = kkt
    inv, ib = _cat(sched, "upd_inv"), _cat(sched, "upd_ib")
    for k, ups in enumerate(_level_updates(sched)):
        p0, p1 = a["pair_ptr"][k], a["pair_ptr"][k + 1]
        pairs = list(zip(a["pair_node"][p0:p1].tolist(), a["pair_slot"][p0:p1].tolist()))
        wanted = {(int(inv[u]), int(ib[u])) for u in ups}
        assert len(pairs) == len(set(pairs)) and set(pairs) == wanted
        for u in ups:
            p = int(a["upd_pair"][u])
            assert p0 <= p < p1
            assert (a["pair_node"][p], a["pair_slot"][p]) == (inv[u], ib[u])
    counts = [len(set(zip(lv.upd_inv.tolist(), lv.upd_ib.tolist()))) for lv in sched.levels]
    assert counts == [8, 4, 8, 4, 8, 4, 1, 0] and L._max_pairs(sched) == 8


def test_targets_group_updates_in_list_order(kkt):
    """Every update appears once, under its own target, and a target's
    updates keep the schedule's order."""
    sched, _, _, a = kkt
    upd_tgt = _cat(sched, "upd_tgt")
    seen = []
    for k, ups in enumerate(_level_updates(sched)):
        for t in range(a["tgt_ptr"][k], a["tgt_ptr"][k + 1]):
            group = a["tgt_upd"][a["tgt_uptr"][t] : a["tgt_uptr"][t + 1]].tolist()
            assert group == sorted(group) and all(u in ups for u in group)
            assert all(upd_tgt[u] == a["tgt_slot"][t] for u in group)
            seen += group
        targets = a["tgt_slot"][a["tgt_ptr"][k] : a["tgt_ptr"][k + 1]].tolist()
        assert len(targets) == len(set(targets))
    assert sorted(seen) == list(range(upd_tgt.size))
    n_targets = [a["tgt_ptr"][k + 1] - a["tgt_ptr"][k] for k in range(len(sched.levels))]
    assert n_targets == [16, 4, 16, 4, 13, 1, 1, 0]


def test_tile_positions(kkt):
    """node_pos numbers each level's nodes 0, 1, ... in level order (the
    factorize kernel keeps one level's LU tiles, indexed by it)."""
    sched, _, _, a = kkt
    for lv in sched.levels:
        assert a["node_pos"][lv.nodes].tolist() == list(range(len(lv.nodes)))
    assert L._max_nodes(sched) == 4


def test_solve_pull_lists_in_list_order(kkt):
    """fin/bin group the forward and backward edges by the node they
    update, in list order; fwd_out marks the nodes with forward edges."""
    sched, _, _, a = kkt
    for ptr, lst, tgt in (("fin_ptr", "fin_e", "fwd_a"), ("bin_ptr", "bin_e", "bwd_i")):
        tgt = _cat(sched, tgt)
        got = []
        for nd in range(sched.n_nodes):
            edges = a[lst][a[ptr][nd] : a[ptr][nd + 1]].tolist()
            assert edges == sorted(edges) and all(tgt[e] == nd for e in edges)
            got += edges
        assert sorted(got) == list(range(tgt.size))
    assert a["fwd_out"].tolist() == [int(nd in set(a["fwd_i"].tolist())) for nd in range(sched.n_nodes)]
    assert min(a["fwd_ai"].min(), a["bwd_ia"].min()) >= sched.n_nodes  # edge slots only


def _lazy_pivot_lu(D, n):
    """The factorize kernel's block LU (csrc/ldu.cu block_lu) in numpy:
    rows stay in place and `pos` records where each would be after
    ldu.blu_factor's row swaps; the pivot is the largest |m[k]| over
    positions k..n-1, on a tie the lowest position.  Returns (LU, PS)."""
    W = D.shape[0]
    m = D.copy()
    rmax = np.abs(m).max(axis=1)
    sc = np.where(rmax > 0, 1.0 / np.where(rmax > 0, rmax, 1.0), 1.0)
    m *= sc[:, None]
    pos = np.arange(W)
    for k in range(n):
        cand = [(abs(m[r, k]), -pos[r], r) for r in range(W) if k <= pos[r] < n]
        pl = max(cand)[2]  # largest value, then lowest position
        at_k = np.flatnonzero(pos == k)[0]
        pos[at_k], pos[pl] = pos[pl], k
        a = m[pl, k]
        a = a if abs(a) > 1e-30 else (-1e-30 if a < 0 else 1e-30)
        for r in range(W):
            if pos[r] > k:
                mult = m[r, k] / a
                m[r, k + 1 :] -= mult * m[pl, k + 1 :]
                m[r, k] = mult
        m[pl, k] = a
    LU, PS = np.empty_like(m), np.zeros_like(m)
    LU[pos] = m
    PS[pos, np.arange(W)] = sc
    return LU, PS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lazy_pivot_lu_matches_blu_factor(seed):
    """Pivot ties included: entries are drawn from a few values, so rows
    scale to exact ±1s and pivot candidates tie."""
    rng = np.random.default_rng(seed)
    n, W = 11, 14
    D = np.tile(np.eye(W), (6, 1, 1))
    D[:, :n, :n] = rng.choice([-2.0, -1.0, 0.0, 0.5, 1.0, 2.0], size=(6, n, n))
    D[:, :n, :n] += 4 * np.eye(n) * rng.integers(0, 2, size=(6, 1, 1))
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    for b in range(6):
        LU, PS = _lazy_pivot_lu(D[b], n)
        np.testing.assert_array_equal(LU, lu[b].numpy())
        np.testing.assert_array_equal(PS, ps[b].numpy())


def _factorize_kernel_order(sched, a, blocks):
    """ldu.factorize in the kernel's order: node LUs of a level, X once per
    pair, then each target over its updates in list order."""
    W, N = sched.width, sched.n_nodes
    fb = blocks.clone()
    LU = blocks.new_zeros(blocks.shape[0], N, W, W)
    PS = torch.zeros_like(LU)
    for k, lv in enumerate(sched.levels):
        nodes = torch.as_tensor(lv.nodes, dtype=torch.long)
        LU[:, nodes], PS[:, nodes] = ldu.blu_factor(fb[:, nodes], lv.real_w)
        X = {}
        for p in range(a["pair_ptr"][k], a["pair_ptr"][k + 1]):
            i, sl = int(a["pair_node"][p]), int(a["pair_slot"][p])
            X[p] = ldu.blu_solve(LU[:, i], PS[:, i], fb[:, sl])
        for t in range(a["tgt_ptr"][k], a["tgt_ptr"][k + 1]):
            acc = fb[:, a["tgt_slot"][t]].clone()
            for u in a["tgt_upd"][a["tgt_uptr"][t] : a["tgt_uptr"][t + 1]]:
                acc -= fb[:, a["upd_ai"][u]] @ X[int(a["upd_pair"][u])]
            fb[:, a["tgt_slot"][t]] = acc
    return fb, LU, PS


def _solve_kernel_order(sched, a, fact, b):
    """ldu.solve in the kernel's order: each node pulls its edges' terms."""
    fb, LU, PS = fact
    b, t, x = b.clone(), torch.zeros_like(b), torch.zeros_like(b)
    mv = lambda E, v: (E @ v.unsqueeze(-1)).squeeze(-1)
    for lv in sched.levels:
        for nd in lv.nodes.tolist():
            for e in a["fin_e"][a["fin_ptr"][nd] : a["fin_ptr"][nd + 1]]:
                b[:, nd] -= mv(fb[:, a["fwd_ai"][e]], t[:, a["fwd_i"][e]])
            if a["fwd_out"][nd]:
                t[:, nd] = ldu.blu_solve(LU[:, nd], PS[:, nd], b[:, nd])
    for lv in reversed(sched.levels):
        for nd in lv.nodes.tolist():
            for e in a["bin_e"][a["bin_ptr"][nd] : a["bin_ptr"][nd + 1]]:
                b[:, nd] -= mv(fb[:, a["bwd_ia"][e]], x[:, a["bwd_a"][e]])
            x[:, nd] = ldu.blu_solve(LU[:, nd], PS[:, nd], b[:, nd])
    return x


def test_kernel_order_matches_plain_f64(kkt):
    sched, blocks, r, a = kkt
    plan = ldu.LduPlan(sched, "cpu")
    ref = ldu.factorize(plan, blocks)
    fact = _factorize_kernel_order(sched, a, blocks)
    for got, want in zip(fact, ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    rhs = ldu.flat_to_nodes(plan, r)
    x = _solve_kernel_order(sched, a, ref, rhs)
    np.testing.assert_allclose(x.numpy(), ldu.solve(plan, ref, rhs).numpy(), rtol=0, atol=1e-12)


def test_shared_memory_sizes(kkt):
    """The quadruped's lane (S=100 slots of 14x14, N=26 nodes, at most 4
    nodes and 8 pairs in a level) with its 984-int schedule: the bytes a
    CTA takes in float32 and float64, and offsets that follow each other
    in the order of the C structs."""
    sched = kkt[0]
    want = {torch.float32: (95392, 99584), torch.float64: (186592, 193568)}
    for dtype, (fact, solve) in want.items():
        for kernel, nbytes in (("factorize", fact), ("solve", solve)):
            layout = L.smem_layout(sched, kernel, dtype)
            assert layout["bytes"] == nbytes
            fields = [n for n, _ in L._LAYOUT_STRUCTS[kernel]._fields_]
            assert list(layout) == fields
            assert [layout[n] for n in fields] == sorted(layout.values())
    # two float32 lanes share an SM (228 KB, 1 KB reserved per CTA)
    assert 2 * (max(want[torch.float32]) + 1024) <= 228 * 1024


def test_schedules_the_kernels_cannot_take_raise(kkt):
    """A lane over the shared-memory limit, or W > 72, raises; the width is
    checked where a kernel would launch, so a schedule of any width still
    builds and takes the plain version on the CPU."""
    sched = kkt[0]
    big = dataclasses.replace(sched, n_slots=200)  # 200 slots of 14x14 in float64
    buf = L.DeviceSchedule(sched, "cpu").buf.numel()
    with pytest.raises(ValueError, match=r"bytes of shared memory"):
        L.smem_layout(big, "factorize", torch.float64, buf)
    assert L.smem_layout(big, "factorize", torch.float32, buf)["bytes"] < L.SMEM_LIMIT
    with pytest.raises(ValueError, match="MAXW"):
        L.width_class(73)
    with pytest.raises(ValueError, match="MAXW"):
        L.smem_layout(dataclasses.replace(sched, width=73), "factorize", torch.float32, buf)
    assert L.DeviceSchedule(dataclasses.replace(sched, width=73), "cpu").sched.width == 73
