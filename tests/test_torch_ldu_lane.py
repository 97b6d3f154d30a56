"""The block-LDU kernels for a lane larger than a CTA (csrc/ldu_lane.cu),
checked on the CPU: which lanes take them, their shared memory, the
schedule they read (ldu_cuda._csr(sched, lane=True)), and a model of their
layout and arithmetic on atlas's KKT.

Atlas (W = 38, N = 62, S = 244, 22 levels) is the one registered model
whose lane at its real rows takes more shared memory than a CTA can have
(345,104 bytes to factorize in float32).  Its kernels keep the lane's
blocks (the solve: the edge blocks, LU and PS) in global memory, where
they lie in the tensors: slot s at s W², node n's LU and PS at n W², and
the factorize works in place in fb; the rest stays in shared memory.  Here:
  - every model that fitted a CTA keeps its width class's kernels, and
    atlas takes the lane kernels in both dtypes, each CTA within the limit;
  - the lane schedule is the real-width schedule with those places, every
    record that holds a place following them;
  - a numpy model of the three kernels that reads and writes the lane
    through those records, with the 33..72 class's block LU models
    (cta_lu for the two 38-wide foot nodes, real_lu at tile 8 for the
    6-wide bodies), against the plain versions on atlas's float64 KKT:
    every block LU bitwise ldu.blu_factor's, fb, the solve and the matvec
    to 1e-12;
  - the plain block-LDU solve of atlas's KKT against a dense solve.
The kernels run only on a card (tests/test_torch_cuda.py, chip_smoke.py's
atlas phase)."""

import numpy as np
import pytest
import torch
from test_torch_cuda import model_kkt
from test_torch_zoo_ldu import _register_lu, _wide_lu

import chip_smoke as C
from dojo_tpu_torch import ldu, ldu_cuda as L, models
from dojo_tpu_torch.graph import build_schedule

KERNELS = ("factorize", "solve", "matvec")
# atlas's CTAs, bytes of shared memory (factorize, solve, matvec), at its
# real rows as the 33..72 class would stage them, and with the lane's
# blocks in global memory
ATLAS_STAGED = {torch.float32: (345104, 379808, 265796), torch.float64: (659280, 729552, 526932)}
ATLAS_LANE = {torch.float32: (93392, 61824, 14084), torch.float64: (155856, 93584, 23508)}


def _schedules():
    """Every registered model's schedule (fourbar has none)."""
    out = {}
    for name in models.registered_models():
        sched = build_schedule(models.get_mechanism(name, device="cpu").topo)
        if sched is not None:
            out[name] = sched
    return out


@pytest.fixture(scope="module")
def atlas():
    """Atlas's schedule, its float64 KKT at B = 1 (test_torch_cuda.model_kkt)
    and the plain factorization of it."""
    sched, blocks, r = model_kkt("atlas", torch.float64, lanes=1)
    plan = ldu.LduPlan(sched, "cpu")
    return sched, blocks, ldu.flat_to_nodes(plan, r), ldu.factorize(plan, blocks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_atlas_takes_the_lane_kernels(dtype):
    """Atlas's lane at its real rows is over a CTA's 232,448 bytes in each
    kernel; smem_layout gives the lane kernels' layout instead of raising,
    without the arrays kept in global memory, each CTA within the limit."""
    sched = build_schedule(models.get_mechanism("atlas", device="cpu").topo)
    assert (sched.width, sched.n_nodes, sched.n_slots, len(sched.levels)) == (38, 62, 244, 22)
    buf = sum(a.size for a in L._csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    for kernel, staged, lane in zip(KERNELS, ATLAS_STAGED[dtype], ATLAS_LANE[dtype]):
        assert sum(L._real_sizes(sched, kernel, elem, buf).values()) == staged > L.SMEM_LIMIT
        assert L.lane_variant(sched, kernel, dtype) and L.variant(sched, kernel, dtype) == "lane"
        layout = L.smem_layout(sched, kernel, dtype)
        assert layout["bytes"] == lane <= L.SMEM_LIMIT
        kept = {"factorize": ("fb",), "solve": ("e", "lu", "ps"), "matvec": ("blocks",)}[kernel]
        sizes = L._real_sizes(sched, kernel, elem, buf, lane=True)
        assert all(sizes[k] == 0 for k in kept) and sum(sizes.values()) == lane
    assert L.shared_chunk(sched, "matvec", dtype, 54) >= 1


def test_fitting_models_keep_their_kernels():
    """Every registered model but atlas takes its width class's kernels in
    both dtypes, at the shared memory of the real-width layout (nothing
    moved to global memory)."""
    for name, sched in _schedules().items():
        buf = sum(a.size for a in L._csr(sched).values())
        for dtype in (torch.float32, torch.float64):
            for kernel in KERNELS:
                got = L.variant(sched, kernel, dtype)
                assert (got == "lane") == (name == "atlas"), (name, kernel, dtype)
                if got != "lane":
                    assert got == L.width_class(sched.width)
                    if got != "w16":
                        elem = torch.empty((), dtype=dtype).element_size()
                        want = sum(L._real_sizes(sched, kernel, elem, buf).values())
                        assert L.smem_layout(sched, kernel, dtype)["bytes"] == want


def test_lane_schedule_places():
    """_csr(sched, lane=True): slot s at s W² and node n's LU and PS at n W²;
    every record that holds a place names the same slot at its lane place,
    and every other array is the real-width schedule's, of the same length
    (one buffer length for both)."""
    sched = build_schedule(models.get_mechanism("atlas", device="cpu").topo)
    a, g = L._csr(sched), L._csr(sched, lane=True)
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    assert g["slot_off"].tolist() == [s * W * W for s in range(S + 1)]
    assert g["node_lu"].tolist() == [n * W * W for n in range(N + 1)]
    to_lane = {int(a["slot_off"][s]): s * W * W for s in range(S)}
    edge = {int(a["slot_off"][s] - a["slot_off"][N]): (s - N) * W * W for s in range(N, S)}
    for name, size, place in (("pair_rec", 5, to_lane), ("tgt_rec", 2, to_lane),
                              ("upd_rec", 3, to_lane), ("fin_rec", 3, edge),
                              ("bin_rec", 3, edge)):
        rec, lane = a[name].reshape(-1, size), g[name].reshape(-1, size)
        assert [place[int(v)] for v in rec[:, 0]] == lane[:, 0].tolist(), name
        np.testing.assert_array_equal(rec[:, 1:], lane[:, 1:], err_msg=name)
    for name in L._ARRAYS:
        assert a[name].size == g[name].size, name
        if name not in ("slot_off", "node_lu", "pair_rec", "tgt_rec", "upd_rec", "fin_rec",
                        "bin_rec"):
            np.testing.assert_array_equal(a[name], g[name], err_msg=name)


def _lane_factorize(sched, g, blocks):
    """fact_lane in numpy on lane 0: fb a copy of the blocks, flat, slot s at
    s W²; per level, each node's block LU from its diagonal block's real
    rows (a level over 32 wide: cta_lu's model; else real_lu's at the
    level's tile, each warp's PER nodes pivoting to their widest), then X
    of each pair and each target over its updates in list order, every
    block found through the lane records.  Returns (fb, LU, PS) as
    (1, ...) tensors."""
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    F = blocks[0].numpy().reshape(-1).copy()
    LU, PS = np.tile(np.eye(W), (N, 1, 1)), np.tile(np.eye(W), (N, 1, 1))
    nw = g["node_w"]
    rows = lambda off, na: F[off : off + na * W].reshape(na, W)
    for k in range(len(sched.levels)):
        tw = int(g["level_tw"][k])
        nodes = g["level_nodes"][g["level_ptr"][k] : g["level_ptr"][k + 1]].tolist()
        G = tw if tw <= 16 else 32
        per = 32 // G
        for q0 in range(0, len(nodes), per):
            warp = nodes[q0 : q0 + per]
            n_loop = max(int(nw[nd]) for nd in warp)
            for nd in warp:
                n = int(nw[nd])
                D = np.eye(W)
                D[:n] = rows(int(g["slot_off"][nd]), n)
                lu, ps = _wide_lu(D, n) if tw > 32 else _register_lu(D, n, tw, G, n_loop)
                LU[nd, :n, :n], PS[nd, :n, :n] = lu, ps
        X = {}
        for p in range(g["pair_ptr"][k], g["pair_ptr"][k + 1]):
            eoff, rc, _, _, xoff = g["pair_rec"][5 * p : 5 * p + 5].tolist()
            i = int(g["pair_node"][p])
            ni, nb = rc >> 8, rc & 255
            y = PS[i, :ni, :ni] @ rows(eoff, ni)[:, :nb]
            y = np.linalg.solve(np.tril(LU[i, :ni, :ni], -1) + np.eye(ni), y)
            X[xoff] = np.linalg.solve(np.triu(LU[i, :ni, :ni]), y)
        for t in range(g["tgt_ptr"][k], g["tgt_ptr"][k + 1]):
            toff, rc = g["tgt_rec"][2 * t : 2 * t + 2].tolist()
            na, nb = rc >> 8, rc & 255
            acc = rows(toff, na)[:, :nb].copy()
            for j in range(g["tgt_uptr"][t], g["tgt_uptr"][t + 1]):
                aoff, ni, xoff = g["upd_rec"][3 * j : 3 * j + 3].tolist()
                acc -= rows(aoff, na)[:, :ni] @ X[xoff]
            rows(toff, na)[:, :nb] = acc
    t = lambda a: torch.as_tensor(a)[None]
    return t(F.reshape(S, W, W)), t(LU), t(PS)


def _lane_solve(sched, g, fact, b):
    """solve_real<T, true, true> in numpy on lane 0: each node pulls its
    edges through fin_rec / bin_rec (the edge block at N W² + its place in
    fb, the other node's vector, its width) and solves with its LU and PS
    read at node_lu (n W²)."""
    W, N = sched.width, sched.n_nodes
    fb, lu, ps = (f[0].numpy().reshape(-1) for f in fact)
    E, nw = fb[N * W * W :], g["node_w"]
    bv, tv, xv = b[0].numpy().reshape(-1).copy(), np.zeros(N * W), np.zeros(N * W)

    def node_solve(nd, v):
        n, lo = int(nw[nd]), int(g["node_lu"][nd])
        LUn = lu[lo : lo + n * W].reshape(n, W)[:, :n]
        PSn = ps[lo : lo + n * W].reshape(n, W)[:, :n]
        y = np.linalg.solve(np.tril(LUn, -1) + np.eye(n), PSn @ v)
        return np.linalg.solve(np.triu(LUn), y)

    def pull(nd, ptr, rec, src):
        n = int(nw[nd])
        v = bv[nd * W : nd * W + n].copy()
        for k in range(g[ptr][nd], g[ptr][nd + 1]):
            eoff, vo, m = g[rec][3 * k : 3 * k + 3].tolist()
            v -= E[eoff : eoff + n * W].reshape(n, W)[:, :m] @ src[vo : vo + m]
        return v

    order = [g["level_nodes"][g["level_ptr"][k] : g["level_ptr"][k + 1]].tolist()
             for k in range(len(sched.levels))]
    for nodes in order:
        for nd in nodes:
            n = int(nw[nd])
            bv[nd * W : nd * W + n] = v = pull(nd, "fin_ptr", "fin_rec", tv)
            if g["fwd_out"][nd]:
                tv[nd * W : nd * W + n] = node_solve(nd, v)
    for nodes in reversed(order):
        for nd in nodes:
            n = int(nw[nd])
            xv[nd * W : nd * W + n] = node_solve(nd, pull(nd, "bin_ptr", "bin_rec", xv))
    pad = np.concatenate([np.arange(W) >= nw[nd] for nd in range(N)])
    return torch.as_tensor(np.where(pad, b[0].numpy().reshape(-1), xv).reshape(N, W))[None]


def _lane_matvec(sched, g, blocks, x):
    """matvec_real<T, true> in numpy on lane 0: each real row sums its
    node's slots in row_slot order, the block read at slot_off (s W²) over
    the other node's real terms; a pad row is the vector's own entry."""
    W, N = sched.width, sched.n_nodes
    F, xv, nw = blocks[0].numpy().reshape(-1), x[0].numpy().reshape(-1), g["node_w"]
    y = xv.copy()
    for a in range(N):
        for r in range(int(nw[a])):
            acc = 0.0
            for e in range(g["row_ptr"][a], g["row_ptr"][a + 1]):
                sl = int(g["row_slot"][e])
                nb, off = int(g["slot_rc"][sl]) & 255, int(g["slot_off"][sl])
                b = int(g["slot_b"][sl])
                acc += F[off + r * W : off + r * W + nb] @ xv[b * W : b * W + nb]
            y[a * W + r] = acc
    return torch.as_tensor(y.reshape(N, W))[None]


def test_lane_model_matches_plain(atlas):
    """The model of the lane kernels on atlas's float64 KKT against the
    plain versions: every block LU and PS bitwise ldu.blu_factor's of the
    block it factored (chip_smoke.lu_vs_plain), fb, the solve and the
    matvec to 1e-12."""
    sched, blocks, b, ref = atlas
    g = L._csr(sched, lane=True)
    fact = _lane_factorize(sched, g, blocks)
    np.testing.assert_allclose(fact[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-12)
    res = C.lu_vs_plain(sched, *fact)
    assert res["blocks"] == sched.n_nodes and res["differ"] == 0, res
    plan = ldu.LduPlan(sched, "cpu")
    np.testing.assert_allclose(_lane_solve(sched, g, fact, b).numpy(),
                               ldu.solve(plan, fact, b).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_lane_matvec(sched, g, blocks, b).numpy(),
                               ldu.matvec(plan, blocks, b).numpy(), rtol=0, atol=1e-12)


def test_atlas_plain_solve_matches_dense(atlas):
    """The plain block LDU (the path a CPU tensor takes, and the kernels'
    reference) solves atlas's KKT as a dense solve of the same blocks does
    (the W-padded system: pad rows identity), to 1e-10 of the solution."""
    sched, blocks, b, fact = atlas
    W, N = sched.width, sched.n_nodes
    A = torch.zeros(N * W, N * W, dtype=torch.float64)
    for (i, j), s in sched.slot.items():
        A[i * W : (i + 1) * W, j * W : (j + 1) * W] = blocks[0, s]
    x = ldu.solve(ldu.LduPlan(sched, "cpu"), fact, b)
    dense = torch.linalg.solve(A, b[0].reshape(-1)).reshape(N, W)
    scale = dense.abs().max().item()
    np.testing.assert_allclose(x[0].numpy(), dense.numpy(), rtol=0, atol=1e-10 * scale)
