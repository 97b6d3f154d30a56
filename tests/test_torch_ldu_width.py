"""The real-width kernels (17..32, and 33..72) work at each node's real
width: their premise on the plain versions, and the device schedule that
carries the real widths.

The kernels of csrc/ldu.cu's 17..32 and 33..72 classes factor each node's
real n x n block (a tile of n rounded up to 8, its pad rows identity, or
over 32 by the whole CTA), form X = D_i⁻¹E_{i,b} and the Schur products
over the real n_i terms, solve at the node's real width (over 32 a thread
a row, a barrier a row) with each edge's row dot over the other node's real
terms, and multiply over the real terms, where the plain versions (ldu.py)
work on W x W blocks at the level's width.  That the two agree rests on
the blocks' pad ([[0, 0], [0, I]], as the assembler makes it): pad pivots
are identity rows and pad terms exact zeros.  Here, on the plain versions
in float32, on the KKTs of humanoid, walker, snake and block
(chip_smoke.model_kkt at B=2):
  - the assembler's pad is the schedule's pad_eye, exactly, for every
    registered model with W > 16 (hopper and twister assembled apart, in
    float64 at B=1);
  - each node's ldu.blu_factor at the level's width equals, bitwise, its
    real block's at the node's width on the real part, and its pad is
    identity in LU and PS;
  - a Schur product and a block solve summed over the real indices equal
    the padded ones, bitwise, on the real part;
  - each node's solve with its factors, and each solve edge's row dot,
    over the real indices equal the padded ones, bitwise (the pad of a
    solution is the right-hand side's); and the 33..72 solve's row by
    row substitution (wide_node_solve) keeps ldu.blu_solve's order, bitwise
    where products are rounded apart.
And on the host: each slot's place (ldu_cuda._csr slot_off, slot_rc)
holds its real rows, the places tile the staged blocks without overlap,
and the level tasks cover each X column and target row once (the shared
memory a lane takes: tests/test_torch_zoo_ldu.py::test_shared_memory_bytes).
The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as C
from dojo_tpu_torch import ldu, ldu_cuda as L, models
from dojo_tpu_torch.graph import build_schedule

MODELS = ("humanoid", "walker", "snake", "block")
# the registered models with W > 16 that the fixture does not assemble
OTHER_WIDE = ("hopper", "twister")


@pytest.fixture(scope="module", params=MODELS)
def factored(request):
    """A model's schedule, its float32 KKT (chip_smoke.model_kkt, B=2, on
    the CPU), the plain factorization of it, and node vectors from a seed
    (pad entries included)."""
    name = request.param
    mech = models.get_mechanism(name, device="cpu").cast(torch.float32)
    sched, ds, blocks, rhs = C.model_kkt(mech, models.initialize(mech, name), 2, "cpu")
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(rhs.shape)),
                        dtype=torch.float32)
    return name, sched, blocks, ldu.factorize(ds.plan, blocks), v


def _real(sched, nd):
    return int(sched.node_width[nd])


def _check_pad(sched, blocks):
    """Every slot's pad entries (rows past n_a or columns past n_b) equal
    the schedule's pad_eye there, exactly: zero, identity on a diagonal
    slot's pad diagonal."""
    W = sched.width
    eye = torch.as_tensor(sched.pad_eye, dtype=blocks.dtype)
    for (a, b), s in sched.slot.items():
        pad = torch.ones(W, W, dtype=torch.bool)
        pad[: _real(sched, a), : _real(sched, b)] = False
        assert torch.equal(blocks[:, s][:, pad], eye[s][pad].expand(blocks.shape[0], -1))


def test_assembler_pad_is_pad_eye(factored):
    """The premise itself: the assembler's blocks (blocks.Assembler, through
    chip_smoke.model_kkt) hold pad_eye's pad (graph.py), on the fixture's
    KKTs."""
    _, sched, blocks, _, _ = factored
    _check_pad(sched, blocks)


def test_wide_models_listed():
    """MODELS and OTHER_WIDE are every registered model with W > 16."""
    wide = {m for m in models.registered_models()
            if build_schedule(models.get_mechanism(m, device="cpu").topo).width > 16}
    assert wide == set(MODELS + OTHER_WIDE)


@pytest.mark.parametrize("name", OTHER_WIDE)
def test_assembler_pad_is_pad_eye_other_wide(name):
    """The same for the other registered models with W > 16, each assembled
    in float64 at B=1 from its initial state."""
    mech = models.get_mechanism(name, device="cpu")
    sched, _, blocks, _ = C.model_kkt(mech, models.initialize(mech, name), 1, "cpu")
    assert sched.width > 16 and blocks.dtype == torch.float64
    _check_pad(sched, blocks)


def test_block_lu_at_real_width_is_bitwise(factored):
    """Each node's block as factored (fb's diagonal slot): blu_factor at the
    level's width equals blu_factor of the real n x n block at width n,
    bitwise, in LU and PS; the pad of both is identity."""
    _, sched, _, (fb, _, _), _ = factored
    W = sched.width
    eye = torch.eye(W, dtype=torch.float32)
    for lv in sched.levels:
        for nd in lv.nodes.tolist():
            n = _real(sched, nd)
            lu, ps = ldu.blu_factor(fb[:, nd].clone(), int(lv.real_w))
            lu_n, ps_n = ldu.blu_factor(fb[:, nd, :n, :n].clone(), n)
            assert torch.equal(lu[:, :n, :n], lu_n) and torch.equal(ps[:, :n, :n], ps_n)
            pad = torch.ones(W, W, dtype=torch.bool)
            pad[:n, :n] = False
            for t in (lu, ps):
                assert torch.equal(t[:, pad], eye.expand_as(t)[:, pad])


def _seq_product(A, X, n):
    """A[..., :, :n] X[..., :n, :], each entry summed over j < n in order."""
    d = torch.zeros(*A.shape[:-1], X.shape[-1], dtype=A.dtype)
    for j in range(n):
        d = d + A[..., :, j : j + 1] * X[..., j : j + 1, :]
    return d


def test_schur_terms_at_real_width_are_bitwise(factored):
    """Each Schur update's X = D_i⁻¹E_{i,b} (ldu.blu_solve) and E_{a,i} X:
    at the level's width (W x W, the pad terms zero) and over the real
    indices only (n_i x n_i factors, n_a x n_i by n_i x n_b), equal
    bitwise on the real part."""
    _, sched, blocks, _, _ = factored
    plan = ldu.LduPlan(sched, "cpu")
    fb = blocks.clone()
    slot_ab = {s: ab for ab, s in sched.slot.items()}
    for lv in sched.levels:
        nodes = torch.as_tensor(lv.nodes)
        LU, PS = ldu.blu_factor(fb[:, nodes].clone(), int(lv.real_w))
        pos = {int(nd): k for k, nd in enumerate(lv.nodes)}
        for ai, i, ib, tgt in zip(lv.upd_ai, lv.upd_inv, lv.upd_ib, lv.upd_tgt):
            na, ni, nb = (_real(sched, slot_ab[int(ai)][0]), _real(sched, int(i)),
                          _real(sched, slot_ab[int(ib)][1]))
            k = pos[int(i)]
            X = ldu.blu_solve(LU[:, k], PS[:, k], fb[:, ib])
            X_n = ldu.blu_solve(LU[:, k, :ni, :ni], PS[:, k, :ni, :ni], fb[:, ib, :ni, :nb])
            assert torch.equal(X[:, :ni, :nb], X_n)
            assert not X[:, ni:].any() and not X[:, :, nb:].any()
            D = _seq_product(fb[:, ai], X, sched.width)
            D_n = _seq_product(fb[:, ai, :na, :ni], X_n, ni)
            assert torch.equal(D[:, :na, :nb], D_n)
        # the level's updates, as ldu.factorize applies them
        if len(lv.upd_tgt):
            k = [pos[int(i)] for i in lv.upd_inv]
            Y = ldu.blu_solve(LU[:, k], PS[:, k], fb[:, lv.upd_ib])
            fb.index_add_(1, torch.as_tensor(lv.upd_tgt), -(fb[:, lv.upd_ai] @ Y))
    torch.testing.assert_close(fb, ldu.factorize(plan, blocks)[0], rtol=0, atol=1e-5)


def test_solve_at_real_width_is_bitwise(factored):
    """The real-width solve's premise: each node's block solve with its
    factors (ldu.blu_solve, LU and PS of ldu.factorize at the level's
    width) of a vector at W equals, bitwise, the solve with the real n x n
    factors of its n real entries, and leaves its pad entries as they are
    (a solution's pad is the right-hand side's); each solve edge's row dot
    over W terms in order equals, bitwise, the same over the other node's
    real terms (the vector's pad entries not zero), and is zero past the
    block's real rows."""
    _, sched, _, (fb, LU, PS), v = factored
    W = sched.width
    for nd in range(sched.n_nodes):
        n = _real(sched, nd)
        x = ldu.blu_solve(LU[:, nd], PS[:, nd], v[:, nd])
        x_n = ldu.blu_solve(LU[:, nd, :n, :n], PS[:, nd, :n, :n], v[:, nd, :n])
        assert torch.equal(x[:, :n], x_n) and torch.equal(x[:, n:], v[:, nd, n:])
    slot_ab = {s: ab for ab, s in sched.slot.items()}
    for lv in sched.levels:
        for s in [int(e) for e in lv.fwd_ai] + [int(e) for e in lv.bwd_ia]:
            a, o = slot_ab[s]
            na, no = _real(sched, a), _real(sched, o)
            D = _seq_product(fb[:, s], v[:, o, :, None], W)
            D_n = _seq_product(fb[:, s, :na, :no], v[:, o, :no, None], no)
            assert torch.equal(D[:, :na], D_n) and not D[:, na:].any()


def _row_solve(lu, ps, b, n):
    """csrc/ldu.cu wide_node_solve's substitution in numpy, thread i holding
    y_i: y = PS·b, then a step a row, forward: y_i -= L_ij y_j for every
    i > j, j ascending; backward: y_j /= U_jj, then y_i -= U_ij y_j for
    every i < j, j descending (float32, each product and difference
    rounded apart)."""
    y = (ps[:n, :n] @ b[:n]).astype(np.float32)
    for j in range(n - 1):
        y[j + 1 :] -= lu[j + 1 : n, j] * y[j]
    for j in reversed(range(n)):
        y[j] /= lu[j, j]
        y[:j] -= lu[:j, j] * y[j]
    return y


def test_row_node_solve_matches_blu_solve(factored):
    """The 33..72 solve substitutes a node wider than 32 a thread a row,
    a barrier a row (wide_node_solve): each row takes ldu.blu_solve's
    updates in its order, so that the numpy model of it, rounding each
    product and difference apart as ldu.blu_solve does on the CPU, equals
    ldu.blu_solve bitwise on every node of lane 0.  On the card nvcc may contract a
    product and its difference into one FMA: there the kernel is held to
    the plain solve within a tolerance (tests/test_torch_cuda.py)."""
    _, sched, _, (_, LU, PS), v = factored
    for nd in range(sched.n_nodes):
        n = _real(sched, nd)
        want = ldu.blu_solve(LU[0, nd], PS[0, nd], v[0, nd])[:n].numpy()
        got = _row_solve(LU[0, nd].numpy(), PS[0, nd].numpy(), v[0, nd].numpy(), n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODELS + OTHER_WIDE)
def test_real_width_schedule_places(name):
    """_csr's real-width arrays (17..32, and block's W = 70): each level's
    tile (its own, or where the tiles up to 32 would switch more than once
    their widest; a level over 32 wide its width rounded up to odd); each
    slot's place holds its n_a real rows,
    W wide, 16-byte aligned, the places tile the staged blocks in slot
    order without overlap; the nodes' tiles (one element apart) and places
    likewise; each level's tasks cover every column of its X tiles and
    every row chunk (at a wide level every row) of every column of its
    targets once, and their records name the blocks and widths of the
    schedule's lists; a wide level's X space holds its LU's scratch."""
    sched = build_schedule(models.get_mechanism(name, device="cpu").topo)
    a = L._csr(sched)
    nw = np.asarray(sched.node_width)
    slot_ab = {s: ab for ab, s in sched.slot.items()}
    assert a["node_w"].tolist() == nw.tolist()
    off = a["slot_off"]
    W = sched.width
    for (p, q), s in sched.slot.items():
        assert a["slot_rc"][s] == nw[p] << 8 | nw[q]
        assert off[s] % 4 == 0 and off[s + 1] - off[s] == -(-nw[p] * W // 4) * 4
    assert off[0] == 0 and (np.diff(off) > 0).all()
    assert (np.diff(a["node_lu"]) == -(-nw * W // 4) * 4).all()
    assert (np.diff(a["node_vec"]) == nw).all()
    tw = np.diff(a["node_tvec"])
    assert (np.diff(a["node_tile"]) == tw * tw + 1).all()
    rec = lambda name, k, size: a[name][size * k : size * (k + 1)].tolist()
    tiles = [L.level_tile(int(lv.real_w)) for lv in sched.levels]
    assert all(t == (int(lv.real_w) | 1 if lv.real_w > 32 else t)
               for t, lv in zip(tiles, sched.levels))
    narrow = [t for t in tiles if t <= 32]
    if sum(x != y for x, y in zip(narrow, narrow[1:])) > 1:
        tiles = [t if t > 32 else max(narrow) for t in tiles]
    assert a["level_tw"].tolist() == tiles
    assert (name == "block") == any(t > 32 for t in tiles)
    x_len = L._real_widths(sched)["x_len"]
    for k, lv in enumerate(sched.levels):
        p0, p1 = a["pair_ptr"][k], a["pair_ptr"][k + 1]
        assert (tw[lv.nodes] == a["level_tw"][k]).all()
        xt = a["xtask"][a["xtask_ptr"][k] : a["xtask_ptr"][k + 1]]
        want, ends = set(), []
        for p in range(p0, p1):
            i, ib = int(a["pair_node"][p]), int(a["pair_slot"][p])
            eoff, rc, tile, tvec, xoff = rec("pair_rec", p, 5)
            nb = nw[slot_ab[ib][1]]
            assert (eoff, rc, tile, tvec) == (off[ib], nw[i] << 8 | nb, a["node_tile"][i],
                                              a["node_tvec"][i])
            ends.append((xoff, xoff + tw[i] * nb))
            want |= {(p - p0, c) for c in range(nb)}
        assert sorted((int(t) >> 7, int(t) & 127) for t in xt) == sorted(want)
        ends.sort()
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(ends, ends[1:]))
        assert all(e1 <= x_len for _, e1 in ends)
        wide = a["level_tw"][k] > 32
        if wide:
            assert L.wide_scratch(int(lv.real_w), int(a["level_tw"][k])) <= x_len
        t0, t1 = a["tgt_ptr"][k], a["tgt_ptr"][k + 1]
        st = a["stask"][a["stask_ptr"][k] : a["stask_ptr"][k + 1]]
        want = set()
        for t in range(t0, t1):
            tgt = int(a["tgt_slot"][t])
            assert rec("tgt_rec", t, 2) == [off[tgt], a["slot_rc"][tgt]]
            for j in range(a["tgt_uptr"][t], a["tgt_uptr"][t + 1]):
                u = int(a["tgt_upd"][j])
                ai, pair = int(a["upd_ai"][u]), int(a["upd_pair"][u])
                assert rec("upd_rec", j, 3) == [off[ai], nw[a["pair_node"][pair]],
                                                rec("pair_rec", pair, 5)[4]]
            rc = a["slot_rc"][tgt]
            want |= {(t - t0, r, c) for r in range(0, rc >> 8, 1 if wide else L.ROW_CHUNK)
                     for c in range(rc & 255)}
        got = [(int(x) >> 14, (int(x) >> 7) & 127, int(x) & 127) for x in st]
        assert len(got) == len(set(got)) and set(got) == want
    N, W = sched.n_nodes, sched.width
    for fwd in (True, False):
        ed, sl, ot = ("fin_e", "fwd_ai", "fwd_i") if fwd else ("bin_e", "bwd_ia", "bwd_a")
        for j, e in enumerate(a[ed]):
            s, o = int(a[sl][e]), int(a[ot][e])
            assert rec("fin_rec" if fwd else "bin_rec", j, 3) == [off[s] - off[N], o * W, nw[o]]
