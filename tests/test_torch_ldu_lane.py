"""The block-LDU kernels for a lane larger than a CTA at its real rows
(csrc/ldu_lane.cu), checked on the CPU: which lanes take them, their shared
memory, the schedules they read (ldu_cuda._csr(sched, packed=True) for the
packed factorize and solve, _csr(sched, lane=True) for the lane matvec),
and a model of their layout and arithmetic on atlas's KKT.

Atlas (W = 38, N = 62, S = 244, 22 levels) is the one registered model
whose lane at its real rows, W wide, takes more shared memory than a CTA
can have (345,104 bytes to factorize in float32).  Packed at each slot's
real rows and real columns it fits one CTA in both dtypes: its factorize
and solve keep the whole lane in shared memory (the float64 factorize
reads its schedule from global memory), and its matvec reads the blocks
where they lie in the tensors (slot s at s W²).  Here:
  - which models and dtypes take the packed kernels (atlas in both, by
    bytes), and that every other model keeps its width class's kernels;
  - the packed schedule: every slot at its real rows and columns, each
    place 16-byte aligned, every record naming the same slot as
    _csr(sched) does with the leading dimension it reads it with; the
    lane matvec's schedule as before;
  - the CTA bytes of each packed kernel and dtype, at or under the limit;
  - a numpy model of the packed factorize and solve and the lane matvec
    that reads and writes the lane through those records (the group LU of
    level 0's 38-wide feet with 3 warps' candidates, real_lu at tile 8 for
    the 6-wide bodies) against the plain versions on atlas's float64 KKT:
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
DTYPES = [torch.float32, torch.float64]
# atlas's CTAs, bytes of shared memory (factorize, solve, matvec), at its
# real rows as the 33..72 class would stage them; packed (the factorize and
# solve; float64's factorize without its 28,320-byte schedule); the matvec
# with the lane's blocks in global memory
ATLAS_STAGED = {torch.float32: (345104, 379808, 265796), torch.float64: (659280, 729552, 526932)}
ATLAS_PACKED = {torch.float32: (139024, 111904, 14084), torch.float64: (219120, 193744, 23508)}


def _schedules():
    """Every registered model's schedule (fourbar has none)."""
    out = {}
    for name in models.registered_models():
        sched = build_schedule(models.get_mechanism(name, device="cpu").topo)
        if sched is not None:
            out[name] = sched
    return out


def _atlas_sched():
    return build_schedule(models.get_mechanism("atlas", device="cpu").topo)


@pytest.fixture(scope="module")
def atlas():
    """Atlas's schedule, its float64 KKT at B = 1 (test_torch_cuda.model_kkt)
    and the plain factorization of it."""
    sched, blocks, r = model_kkt("atlas", torch.float64, lanes=1)
    plan = ldu.LduPlan(sched, "cpu")
    return sched, blocks, ldu.flat_to_nodes(plan, r), ldu.factorize(plan, blocks)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_atlas_takes_the_lane_kernels(dtype):
    """Atlas's lane at its real rows is over a CTA's 232,448 bytes in each
    kernel; its factorize and solve take the packed kernels and its matvec
    the lane kernel, in both dtypes, and smem_layout gives their layouts,
    each CTA within the limit."""
    sched = _atlas_sched()
    assert (sched.width, sched.n_nodes, sched.n_slots, len(sched.levels)) == (38, 62, 244, 22)
    buf = sum(a.size for a in L._csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    for kernel, staged, packed in zip(KERNELS, ATLAS_STAGED[dtype], ATLAS_PACKED[dtype]):
        assert sum(L._real_sizes(sched, kernel, elem, buf).values()) == staged > L.SMEM_LIMIT
        assert L.variant(sched, kernel, dtype) == ("lane" if kernel == "matvec" else "packed")
        layout = L.smem_layout(sched, kernel, dtype)
        assert layout["bytes"] == packed <= L.SMEM_LIMIT
    sizes = L._real_sizes(sched, "matvec", elem, buf, lane=True)
    assert sizes["blocks"] == 0 and sum(sizes.values()) == ATLAS_PACKED[dtype][2]
    assert L.shared_chunk(sched, "matvec", dtype, 54) >= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_packed_cta_bytes(dtype):
    """Each packed kernel's CTA: its arrays as _packed_sizes
    gives them, 16-byte aligned, at or under SMEM_LIMIT; the factorize
    stages the schedule where it fits (float32) and reads it from global
    memory where it does not (float64: 247,440 bytes with it), the solve
    always stages it."""
    sched = _atlas_sched()
    buf = sum(a.size for a in L._csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    for kernel in ("factorize", "solve"):
        sizes = L._packed_sizes(sched, kernel, elem, buf)
        assert all(v % 16 == 0 for v in sizes.values()), sizes
        layout = L.smem_layout(sched, kernel, dtype)
        with_si = sum(sizes.values())
        if kernel == "factorize" and dtype == torch.float64:
            assert with_si == 247440 > L.SMEM_LIMIT
            assert layout["si"] == -1 and layout["bytes"] == with_si - sizes["si"]
        else:
            assert layout["si"] >= 0 and layout["bytes"] == with_si
        assert layout["bytes"] <= L.SMEM_LIMIT
        offs = [layout[k] for k in sizes if k != "si" or layout["si"] >= 0]
        assert all(o % 16 == 0 for o in offs)


def test_fitting_models_keep_their_kernels():
    """Over every registered model and both dtypes: only atlas takes the
    kernels of csrc/ldu_lane.cu (packed factorize and solve, lane matvec);
    every other model takes its width class's kernels at the shared memory
    of the real-width layout; and no model needs the lane factorize or
    solve (which keep a lane in global memory): every lane over a CTA at
    its real rows fits packed."""
    for name, sched in _schedules().items():
        buf = sum(a.size for a in L._csr(sched).values())
        for dtype in DTYPES:
            for kernel in KERNELS:
                got = L.variant(sched, kernel, dtype)
                assert (got in L.LANE_VARIANTS) == (name == "atlas"), (name, kernel, dtype)
                assert L.smem_layout(sched, kernel, dtype)["bytes"] <= L.SMEM_LIMIT
                if got not in L.LANE_VARIANTS:
                    assert got == L.width_class(sched.width)
                    if got != "w16":
                        elem = torch.empty((), dtype=dtype).element_size()
                        want = sum(L._real_sizes(sched, kernel, elem, buf).values())
                        assert L.smem_layout(sched, kernel, dtype)["bytes"] == want


def test_lane_schedule_places():
    """_csr(sched, lane=True), the lane matvec's: slot s at s W²; every
    record that holds a place names the same slot at its lane place, and
    every other array is the real-width schedule's, of the same length
    (one buffer length for both)."""
    sched = _atlas_sched()
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


def test_packed_schedule_places():
    """_csr(sched, packed=True): slot (a, b) at its n_a x n_b real entries,
    each place 4 elements aligned (16 bytes in float32); node n's LU at its
    n x n; each record names the same slot as _csr(sched) does, with the
    leading dimension it reads the block with: E_{i,b} and a target n_b, an
    update's E_{a,i} n_i (fields unchanged), a pair's LU its node's tile
    stride (ld << 16 in its width field), a solve edge the other node's
    width at its real vector offset (node_vec); a wide level's tile is its
    narrow tile << 8 | its widest | 1.  The arrays that hold no place are
    the real-width schedule's."""
    sched = _atlas_sched()
    a, g = L._csr(sched), L._csr(sched, packed=True)
    N, S = sched.n_nodes, sched.n_slots
    rc = a["slot_rc"]
    sizes = np.diff(g["slot_off"])
    assert (g["slot_off"] % 4 == 0).all() and (g["node_lu"] % 4 == 0).all()
    assert sizes.tolist() == [-(-int((r >> 8) * (r & 255)) // 4) * 4 for r in rc]
    assert np.diff(g["node_lu"]).tolist() == [-(-int(n * n) // 4) * 4 for n in a["node_w"]]
    assert int(g["slot_off"][-1]) == 13136  # the real entries: every place a multiple of 4
    to_packed = {int(a["slot_off"][s]): int(g["slot_off"][s]) for s in range(S)}
    edge = {int(a["slot_off"][s] - a["slot_off"][N]): int(g["slot_off"][s] - g["slot_off"][N])
            for s in range(N, S)}
    for name, size, place in (("tgt_rec", 2, to_packed), ("upd_rec", 3, to_packed),
                              ("fin_rec", 3, edge), ("bin_rec", 3, edge)):
        rec, pk = a[name].reshape(-1, size), g[name].reshape(-1, size)
        assert [place[int(v)] for v in rec[:, 0]] == pk[:, 0].tolist(), name
        if name == "upd_rec":
            np.testing.assert_array_equal(rec[:, 1], pk[:, 1], err_msg=name)
        elif name != "tgt_rec":
            other = rec[:, 1] // sched.width
            np.testing.assert_array_equal(pk[:, 1], g["node_vec"][other], err_msg=name)
            np.testing.assert_array_equal(rec[:, 2], pk[:, 2], err_msg=name)
        else:
            np.testing.assert_array_equal(rec[:, 1], pk[:, 1], err_msg=name)
    rec, pk = a["pair_rec"].reshape(-1, 5), g["pair_rec"].reshape(-1, 5)
    nodes = a["pair_node"]
    assert [to_packed[int(v)] for v in rec[:, 0]] == pk[:, 0].tolist()
    ld = g["node_tvec"][nodes + 1] - g["node_tvec"][nodes]
    np.testing.assert_array_equal(pk[:, 1], ld << 16 | rec[:, 1])
    np.testing.assert_array_equal(pk[:, 2], g["node_tile"][nodes])
    np.testing.assert_array_equal(pk[:, 3], g["node_tvec"][nodes])
    nw = a["node_w"]
    for k, lv in enumerate(sched.levels):
        tw = int(g["level_tw"][k])
        if lv.real_w > 32:
            narrow = max(int(nw[n]) for n in lv.nodes if nw[n] <= 32)
            assert tw == L.level_tile(narrow) << 8 | (int(lv.real_w) | 1)
            for n in lv.nodes:  # a wide node's LU at stride n | 1, a narrow one's at its tile
                stride = g["node_tvec"][n + 1] - g["node_tvec"][n]
                assert stride == (int(nw[n]) | 1 if nw[n] > 32 else tw >> 8)
        else:
            assert tw == a["level_tw"][k]
    same = set(L._ARRAYS) - {"slot_off", "node_lu", "pair_rec", "tgt_rec", "upd_rec",
                             "fin_rec", "bin_rec", "level_tw", "node_tile", "node_tvec"}
    for name in same:
        np.testing.assert_array_equal(a[name], g[name], err_msg=name)


def _packed_factorize(sched, g, blocks):
    """fact_packed in numpy on lane 0: each slot's real entries staged at
    its packed place (leading dimension n_b); per level, each node's block
    LU from its diagonal block (a wide level: the group LU with 3 warps'
    candidates for a node up to GROUP_MAXW wide, cta_lu's 8 for a wider
    one, real_lu at the narrow tile for the others, PER nodes a warp); then
    X of each pair and each target over its updates in list order, every
    block found through the packed records at its leading dimension.  The
    outputs W wide: the pad zero, identity on the diagonal blocks.  Returns
    (fb, LU, PS) as (1, ...) tensors."""
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    nw, off, rc = g["node_w"], g["slot_off"], g["slot_rc"]
    F = np.zeros(int(off[-1]))
    for s in range(S):
        na, nb = int(rc[s]) >> 8, int(rc[s]) & 255
        F[off[s] : off[s] + na * nb] = blocks[0, s, :na, :nb].numpy().reshape(-1)
    blk = lambda o, na, ld: F[o : o + na * ld].reshape(na, ld)
    LU, PS = np.tile(np.eye(W), (N, 1, 1)), np.tile(np.eye(W), (N, 1, 1))

    def lus(nodes, tw):  # a group of PER nodes a warp, pivoting to their widest
        G = tw if tw <= 16 else 32
        per = 32 // G
        for q0 in range(0, len(nodes), per):
            warp = nodes[q0 : q0 + per]
            n_loop = max(int(nw[nd]) for nd in warp)
            for nd in warp:
                n = int(nw[nd])
                lu, ps = _register_lu(blk(int(off[nd]), n, n), n, tw, G, n_loop)
                LU[nd, :n, :n], PS[nd, :n, :n] = lu, ps

    for k in range(len(sched.levels)):
        tw = int(g["level_tw"][k])
        nodes = g["level_nodes"][g["level_ptr"][k] : g["level_ptr"][k + 1]].tolist()
        if (tw & 255) > 32:
            for nd in nodes:
                n = int(nw[nd])
                if n > 32:
                    warps = 3 if n <= L.GROUP_MAXW else 8
                    LU[nd, :n, :n], PS[nd, :n, :n] = _wide_lu(blk(int(off[nd]), n, n), n, warps)
            lus([nd for nd in nodes if nw[nd] <= 32], tw >> 8)
        else:
            lus(nodes, tw)
        X = {}
        for p in range(g["pair_ptr"][k], g["pair_ptr"][k + 1]):
            eoff, f1, _, _, xoff = g["pair_rec"][5 * p : 5 * p + 5].tolist()
            i = int(g["pair_node"][p])
            ni, nb = (f1 >> 8) & 255, f1 & 255
            y = PS[i, :ni, :ni] @ blk(eoff, ni, nb)
            y = np.linalg.solve(np.tril(LU[i, :ni, :ni], -1) + np.eye(ni), y)
            X[xoff] = np.linalg.solve(np.triu(LU[i, :ni, :ni]), y)
        for t in range(g["tgt_ptr"][k], g["tgt_ptr"][k + 1]):
            toff, trc = g["tgt_rec"][2 * t : 2 * t + 2].tolist()
            na, nb = trc >> 8, trc & 255
            acc = blk(toff, na, nb).copy()
            for j in range(g["tgt_uptr"][t], g["tgt_uptr"][t + 1]):
                aoff, ni, xoff = g["upd_rec"][3 * j : 3 * j + 3].tolist()
                acc -= blk(aoff, na, ni) @ X[xoff]
            blk(toff, na, nb)[:] = acc
    fb = np.zeros((S, W, W))
    fb[:N] = np.eye(W)
    for s in range(S):
        na, nb = int(rc[s]) >> 8, int(rc[s]) & 255
        fb[s, :na, :] = 0.0
        fb[s, :, :nb][:na] = blk(int(off[s]), na, nb)
        if s < N:
            fb[s, :na, na:] = 0.0
    t = lambda a: torch.as_tensor(a)[None]
    return t(fb), t(LU), t(PS)


def _packed_solve(sched, g, fact, b):
    """solve_packed in numpy on lane 0: the edge blocks at their packed
    places, each node's n x n LU, its PS from the W-wide tensor, the
    vectors at their real offsets (node_vec); each node pulls its edges
    through fin_rec / bin_rec (the edge block's packed place, the other
    node's vector offset, its width: the leading dimension) and solves with
    its LU and PS; a solution's pad is the right-hand side's."""
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    fb, lu, ps = (f[0].numpy() for f in fact)
    nw, off, rc = g["node_w"], g["slot_off"], g["slot_rc"]
    e0 = int(off[N])
    E = np.zeros(int(off[-1]) - e0)
    for s in range(N, S):
        na, nb = int(rc[s]) >> 8, int(rc[s]) & 255
        E[off[s] - e0 : off[s] - e0 + na * nb] = fb[s, :na, :nb].reshape(-1)
    LUc = np.zeros(int(g["node_lu"][-1]))
    for nd in range(N):
        n, lo = int(nw[nd]), int(g["node_lu"][nd])
        LUc[lo : lo + n * n] = lu[nd, :n, :n].reshape(-1)
    vec = g["node_vec"]
    bv = np.concatenate([b[0, nd, : nw[nd]].numpy() for nd in range(N)])
    tv, xv = np.zeros_like(bv), np.zeros_like(bv)

    def node_solve(nd, v):
        n, lo = int(nw[nd]), int(g["node_lu"][nd])
        LUn = LUc[lo : lo + n * n].reshape(n, n)
        y = np.linalg.solve(np.tril(LUn, -1) + np.eye(n), ps[nd, :n, :n] @ v)
        return np.linalg.solve(np.triu(LUn), y)

    def pull(nd, ptr, rec, src):
        n, vo = int(nw[nd]), int(vec[nd])
        v = bv[vo : vo + n].copy()
        for k in range(g[ptr][nd], g[ptr][nd + 1]):
            eoff, so, m = g[rec][3 * k : 3 * k + 3].tolist()
            v -= E[eoff : eoff + n * m].reshape(n, m) @ src[so : so + m]
        return v

    order = [g["level_nodes"][g["level_ptr"][k] : g["level_ptr"][k + 1]].tolist()
             for k in range(len(sched.levels))]
    for nodes in order:
        for nd in nodes:
            vo, n = int(vec[nd]), int(nw[nd])
            bv[vo : vo + n] = v = pull(nd, "fin_ptr", "fin_rec", tv)
            if g["fwd_out"][nd]:
                tv[vo : vo + n] = node_solve(nd, v)
    for nodes in reversed(order):
        for nd in nodes:
            vo, n = int(vec[nd]), int(nw[nd])
            xv[vo : vo + n] = node_solve(nd, pull(nd, "bin_ptr", "bin_rec", xv))
    out = b[0].numpy().copy()
    for nd in range(N):
        out[nd, : nw[nd]] = xv[vec[nd] : vec[nd] + nw[nd]]
    return torch.as_tensor(out)[None]


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
    """The model of the packed factorize and solve and of the lane matvec
    on atlas's float64 KKT against the plain versions: every block LU and
    PS bitwise ldu.blu_factor's of the block it factored
    (chip_smoke.lu_vs_plain), fb (pads included), the solve and the matvec
    to 1e-12."""
    sched, blocks, b, ref = atlas
    g = L._csr(sched, packed=True)
    fact = _packed_factorize(sched, g, blocks)
    np.testing.assert_allclose(fact[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-12)
    res = C.lu_vs_plain(sched, *fact)
    assert res["blocks"] == sched.n_nodes and res["differ"] == 0, res
    plan = ldu.LduPlan(sched, "cpu")
    np.testing.assert_allclose(_packed_solve(sched, g, fact, b).numpy(),
                               ldu.solve(plan, fact, b).numpy(), rtol=0, atol=1e-12)
    lane = L._csr(sched, lane=True)
    np.testing.assert_allclose(_lane_matvec(sched, lane, blocks, b).numpy(),
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


def test_builds_a_library_a_kernel(tmp_path, monkeypatch):
    """ldu_cuda.start_builds runs eight nvcc processes at once: csrc/ldu.cu
    for each dtype and csrc/ldu_lane.cu for each dtype and kernel (its
    LDU_LANE_PART), each library under a key of its own; a build asked for
    while the same library builds waits for it and runs no second nvcc
    (checked with a stand-in for nvcc that logs its flags and writes its
    output)."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$@\" >> " + str(log) + "\nsleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\ntouch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(L, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(L, "BUILD_DIR", str(tmp_path / "build"))
    futures = L.start_builds()
    assert sorted(futures) == sorted(
        [("ldu.cu", e) for e in (4, 8)]
        + [(f"ldu_lane.cu:{k}", e) for k in ("factorize", "solve", "matvec") for e in (4, 8)])
    again = L.build(("LDU_ELEM=8", "LDU_LANE_PART=1"), L.LANE_SOURCE)[0]
    built = {key: f.result() for key, f in futures.items()}
    assert again == built["ldu_lane.cu:factorize", 8][0]
    assert len({path for path, _, _ in built.values()}) == 8
    calls = log.read_text().splitlines()
    assert len(calls) == 8
    for (name, elem), (path, _, _) in built.items():
        flags = next(c for c in calls if path in c)
        assert f"-DLDU_ELEM={elem}" in flags
        part = L.LANE_PARTS.get(name.partition(":")[2])
        assert ("-DLDU_LANE_PART" in flags) == (part is not None)
        if part is not None:
            assert f"-DLDU_LANE_PART={part}" in flags and flags.endswith("ldu_lane.cu")
