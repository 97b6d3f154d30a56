"""The three block-LDU kernels (csrc/ldu.cu) and their wrappers.

Each wrapper takes the plain PyTorch version (ldu.py) for a tensor on the
CPU, at any block width, and launches the CUDA kernel for a tensor on a
CUDA device; a CUDA tensor the kernels cannot take (W > MAXW = 72, a lane
of W <= 16 over the shared-memory limit of a CTA (``smem_layout``), not
contiguous, not float32/float64, not (B, ...) batch-major) raises.  There
is no fallback.

The kernels come in three width classes (``WIDTH_CLASSES``), each a kernel
of its own picked from the schedule's block width W: W <= 16 (a half-warp
per block, tiles padded to 16), 17..32 (factorize, solve and matvec at
each node's real width: a level's tile is its widest node rounded up to 8,
16, 24 or 32, groups of 8 or 16 lanes or a warp per node, blocks staged at
their real size) and 33..72 (the same kernels at each node's real width,
a node wider than 32 factored by the whole CTA and substituted a thread
a row, a barrier a row; the matvec is the 17..32 class's).  The real-width
kernels take the input blocks' pad as the assembler makes it: zero,
identity on the diagonal blocks.  A lane of 17..72 whose real-width layout
does not fit a CTA's shared memory (atlas: W = 38, 62 nodes, 244 slots)
takes the kernels of csrc/ldu_lane.cu instead: the same code with the
lane's blocks (and the solve's LU and PS) read and written where they lie
in global memory, and the rest in shared memory (variant "lane":
``variant``).  Each wrapper counts its kernel launches in
``<wrapper>.launches`` (a plain integer, all kernels) and per variant (the
width classes and "lane", ``VARIANTS``) in ``<wrapper>.class_launches``.

The libraries (csrc/ldu.cu, and csrc/ldu_lane.cu, which includes it; each
built for one dtype, LDU_ELEM) are built at first use with nvcc for sm_90a
into ``_build/`` (listed in .gitignore), each keyed on a hash of its
sources and flags (``build_all`` runs the four nvcc processes at once), and
loaded with ctypes: a plain C interface, no PyTorch headers.
The schedule goes to the device once per solver as one int32 buffer in CSR
form (``DeviceSchedule``); the kernels loop over it at run time, so one
build serves every mechanism.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from . import ldu
from .graph import Schedule
from .ldu import flat_to_nodes, nodes_to_flat  # noqa: F401  (node-vector gathers)

MAXW = 72  # the widest block the kernels take (csrc/ldu.cu ldu_max_width)
# width classes: name -> (widest W, groups of a CTA (each works on one block))
WIDTH_CLASSES = {"w16": (16, 16), "w32": (32, 8), "w72": (MAXW, 1)}
# the kernels a launch may take: a width class's, or (17..72, a lane over a
# CTA's shared memory) the lane-in-global-memory kernels of csrc/ldu_lane.cu
VARIANTS = (*WIDTH_CLASSES, "lane")


def width_class(W: int) -> str:
    """The kernels' class for block width W (raises for W > MAXW)."""
    for name, (widest, _) in WIDTH_CLASSES.items():
        if W <= widest:
            return name
    raise ValueError(f"block width {W} exceeds the kernels' MAXW={MAXW}")


def tile_width(W: int) -> int:
    """The padded width of a W x W tile (csrc/ldu.cu ldu_tile): 16 for
    W <= 16, W itself for 33..72.  The 17..32 class has no single tile:
    each level takes its own (``level_tiles``), and this raises ValueError."""
    cls = width_class(W)
    if cls == "w32":
        raise ValueError(f"block width {W}: the 17..32 class has no single tile")
    return 16 if cls == "w16" else W

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ldu.cu")
LANE_SOURCE = os.path.join(os.path.dirname(SOURCE), "ldu_lane.cu")  # includes ldu.cu
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# C struct Sched: 4 ints, then these device pointers, in this order
_INTS = ("n_levels", "n_nodes", "n_slots", "width")
_ARRAYS = (
    "level_ptr", "level_nodes", "level_w", "node_pos",
    "upd_ai", "upd_pair", "pair_ptr", "pair_node", "pair_slot",
    "tgt_ptr", "tgt_slot", "tgt_uptr", "tgt_upd",
    "fwd_ai", "fwd_i", "fwd_out", "fin_ptr", "fin_e",
    "bwd_ia", "bwd_a", "bin_ptr", "bin_e",
    "row_ptr", "row_slot", "slot_b",
    # the real widths of the 17..32 and 33..72 classes (empty for W <= 16)
    "level_tw", "node_w", "slot_rc", "slot_off", "node_tile", "node_tvec", "pair_rec", "xtask_ptr",
    "xtask",
    "tgt_rec", "upd_rec", "stask_ptr", "stask", "node_lu", "node_vec", "fin_rec", "bin_rec",
)
SMEM_LIMIT = 232448  # dynamic shared memory one CTA may opt into on sm_90 (227 KB)
# the most a CTA may take for two to share an SM (228 KB, 1 KB reserved per CTA)
SMEM_HALF = 233472 // 2 - 1024
SHARED_MAXKC = 32  # columns a shared-factor solve CTA takes (csrc/ldu.cu MULTI_MAXKC)


class _Sched(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _INTS] + [
        (n, ctypes.c_void_p) for n in _ARRAYS
    ] + [("buf", ctypes.c_void_p), ("buf_len", ctypes.c_int)]


class _FactLayout(ctypes.Structure):  # C struct FactLayout (see smem_layout)
    _fields_ = [(n, ctypes.c_int)
                for n in ("fb", "lu", "x", "rd", "psc", "prow", "si", "bytes")]


class _SolveLayout(ctypes.Structure):  # C struct SolveLayout (see smem_layout)
    _fields_ = [(n, ctypes.c_int)
                for n in ("e", "lu", "rd", "psc", "b", "t", "x", "y", "ps", "prow", "si",
                          "bytes")]


_LAYOUT_STRUCTS = {"factorize": _FactLayout, "solve": _SolveLayout,
                   "solve_shared": _SolveLayout}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")
    return path


def build(defines: tuple = (), source: str = SOURCE) -> tuple[str, str]:
    """Compile ``source`` (csrc/ldu.cu, or csrc/ldu_lane.cu) into a shared
    library unless a build of the same sources and flags exists;
    ``defines`` are macros to set (LDU_PHASES: the real-width kernels' phase
    stamps, scripts/ldu_phase_split.py).  Returns (library path, ptxas
    report: each kernel's registers, spills and shared memory)."""
    src = b""
    for path in dict.fromkeys((SOURCE, source)):  # ldu_lane.cu includes ldu.cu
        with open(path, "rb") as f:
            src += f.read()
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0].replace("ldu", "dojo_ldu")
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{key}.so")
    log = lib + ".ptxas.txt"
    if os.path.exists(lib):
        return lib, open(log).read() if os.path.exists(log) else ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _elem_define(elem: int) -> tuple:
    """The macro that builds a library's entry points for one dtype (elem
    4: float32, 8: float64)."""
    return (f"LDU_ELEM={elem}",)


def build_all(defines: tuple = ()) -> dict:
    """Build the libraries the wrappers load, csrc/ldu.cu's and
    csrc/ldu_lane.cu's for each dtype, at once, an nvcc process each (see
    build).  Returns {(source file, elem): (library path, ptxas report,
    seconds)}."""
    import concurrent.futures
    import time

    def one(source, elem):
        t = time.perf_counter()
        return (*build(defines + _elem_define(elem), source), time.perf_counter() - t)

    jobs = [(src, elem) for src in (SOURCE, LANE_SOURCE) for elem in (4, 8)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = {(os.path.basename(src), elem): pool.submit(one, src, elem) for src, elem in jobs}
        return {key: f.result() for key, f in done.items()}


_LIBS: dict = {}


def _dtype(elem: int) -> str:
    return {4: "f32", 8: "f64"}[elem]


def lane_library(elem: int) -> ctypes.CDLL:
    """The loaded library of csrc/ldu_lane.cu (the kernels for a lane over
    a CTA's shared memory) for float32 (elem 4) or float64 (8), built and
    loaded once per process."""
    if ("lane", elem) not in _LIBS:
        lib = ctypes.CDLL(build(_elem_define(elem), LANE_SOURCE)[0])
        p, i, dt = ctypes.c_void_p, ctypes.c_int, _dtype(elem)
        getattr(lib, f"ldu_lane_factorize_{dt}").argtypes = [p, p, i, p, p, p, p, p]
        getattr(lib, f"ldu_lane_solve_{dt}").argtypes = [p, p, i, i, p, p, p, p, p, p]
        getattr(lib, f"ldu_lane_matvec_{dt}").argtypes = [p, i, i, i, i, i, p, p, p, p]
        for fn in ("factorize", "solve", "matvec"):
            getattr(lib, f"ldu_lane_{fn}_{dt}").restype = i
        lib.ldu_lane_kernel_smem.argtypes = [i, i]
        lib.ldu_lane_kernel_smem.restype = i
        if lib.ldu_lane_max_width() != MAXW:
            raise RuntimeError("csrc/ldu_lane.cu's widest block differs from ldu_cuda.MAXW")
        _LIBS["lane", elem] = lib
    return _LIBS["lane", elem]


def library(elem: int, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded kernel library of csrc/ldu.cu with the entry points of
    float32 (elem 4) or float64 (8), built with ``defines`` (see build) and
    loaded once per process.  The wrappers launch the plain build's of
    their dtype."""
    key = defines, elem
    if key not in _LIBS:
        path, _ = build(defines + _elem_define(elem))
        lib = ctypes.CDLL(path)
        p, i, dt = ctypes.c_void_p, ctypes.c_int, _dtype(elem)
        getattr(lib, f"ldu_factorize_{dt}").argtypes = [p, p, i, p, p, p, p, p]
        getattr(lib, f"ldu_solve_{dt}").argtypes = [p, p, i, i, i, p, p, p, p, p, p]
        getattr(lib, f"ldu_matvec_{dt}").argtypes = [p, i, i, i, i, i, p, p, p, p]
        for fn in ("factorize", "solve", "matvec"):
            getattr(lib, f"ldu_{fn}_{dt}").restype = i
        lib.ldu_max_width.restype = i
        lib.ldu_tile.argtypes = [i]
        lib.ldu_tile.restype = i
        lib.ldu_kernel_smem.argtypes = [i, i, i]
        lib.ldu_kernel_smem.restype = i
        lib.ldu_set_stamps.argtypes = [p]
        lib.ldu_set_stamps.restype = i
        lib.ldu_stamps_per_cta.restype = i
        if lib.ldu_max_width() != MAXW:
            raise RuntimeError("csrc/ldu.cu's widest block differs from ldu_cuda.MAXW")
        if any(lib.ldu_tile(W) != (-1 if width_class(W) == "w32" else tile_width(W))
               for W in range(1, MAXW + 1)):
            raise RuntimeError("csrc/ldu.cu ldu_tile differs from ldu_cuda.tile_width")
        _LIBS[key] = lib
    return _LIBS[key]


def _grouped(keys, n_keys=None):
    """Indices 0..len(keys)-1 grouped by key, ascending within a group.
    Returns (group keys in order of first appearance, or 0..n_keys-1 when
    n_keys is given; CSR offsets; grouped indices)."""
    keys = list(keys)
    order = list(dict.fromkeys(keys)) if n_keys is None else list(range(n_keys))
    members = {k: [] for k in order}
    for idx, k in enumerate(keys):
        members[k].append(idx)
    counts = [len(members[k]) for k in order]
    return order, np.cumsum([0] + counts), [idx for k in order for idx in members[k]]


def _csr(sched: Schedule, lane: bool = False) -> dict:
    """The schedule's lists as int32 arrays in CSR form (see struct Sched).
    ``lane``: for the kernels of a lane over a CTA (csrc/ldu_lane.cu), which
    find slot s at s W² and node n's LU and PS at n W² (``_real_widths``).

    Besides the schedule's own lists, the kernels read lists derived from
    them.  Factorize: each node's position in its level (``node_pos``, the
    index of its LU tile), per level the distinct (i, b) pairs of its Schur
    updates (``pair_node``, ``pair_slot``; ``upd_pair`` maps each update to
    its pair) and its targets (``tgt_slot``), each with its updates in list
    order (``tgt_uptr``/``tgt_upd``).  Solve: the forward and backward edges
    grouped by the node they update, in list order (``fin_*``, ``bin_*``),
    and which nodes have forward edges (``fwd_out``)."""
    ptr = lambda lists: np.cumsum([0] + [len(x) for x in lists])
    cat = lambda lists: np.concatenate([np.asarray(x, dtype=np.int64) for x in lists] or [[]])
    lv = sched.levels
    N = sched.n_nodes
    slot_a = np.zeros(sched.n_slots, dtype=np.int64)
    slot_b = np.zeros(sched.n_slots, dtype=np.int64)
    for (a, b), s in sched.slot.items():
        slot_a[s], slot_b[s] = a, b
    row_slot = np.argsort(slot_a, kind="stable")
    pair_node, pair_slot, pair_ptr, upd_pair = [], [], [0], []
    tgt_slot, tgt_ptr, tgt_uptr, tgt_upd = [], [0], [0], []
    u0 = 0
    for level in lv:
        keys = list(zip(level.upd_inv.tolist(), level.upd_ib.tolist()))
        pairs = list(dict.fromkeys(keys))
        upd_pair += [len(pair_node) + pairs.index(k) for k in keys]
        pair_node += [i for i, _ in pairs]
        pair_slot += [ib for _, ib in pairs]
        pair_ptr.append(len(pair_node))
        tgts, offs, grouped = _grouped(level.upd_tgt.tolist())
        tgt_slot += tgts
        tgt_uptr += [tgt_uptr[-1] + int(o) for o in offs[1:]]
        tgt_upd += [u0 + idx for idx in grouped]
        tgt_ptr.append(len(tgt_slot))
        u0 += len(level.upd_tgt)
        # the kernel's phases read E_{a,i} and E_{i,b} while they write the
        # targets: no target may hold a node of its own level
        held = {int(slot_a[t]) for t in tgts} | {int(slot_b[t]) for t in tgts}
        if held & {int(n) for n in level.nodes}:
            raise ValueError("a Schur update targets a block of a node of its own level")
    fwd_a, bwd_i = cat([l.fwd_a for l in lv]), cat([l.bwd_i for l in lv])
    _, fin_ptr, fin_e = _grouped(fwd_a.tolist(), N)
    _, bin_ptr, bin_e = _grouped(bwd_i.tolist(), N)
    fwd_i = cat([l.fwd_i for l in lv])
    node_pos = np.zeros(N, dtype=np.int64)
    for level in lv:
        node_pos[level.nodes] = np.arange(len(level.nodes))
    fwd_out = np.zeros(N, dtype=np.int64)
    fwd_out[fwd_i] = 1
    fwd_ai, bwd_ia = cat([l.fwd_ai for l in lv]), cat([l.bwd_ia for l in lv])
    arrays = {
        "level_ptr": ptr([l.nodes for l in lv]),
        "level_nodes": cat([l.nodes for l in lv]),
        "level_w": np.asarray([l.real_w for l in lv]),
        "node_pos": node_pos,
        "upd_ai": cat([l.upd_ai for l in lv]),
        "upd_pair": upd_pair,
        "pair_ptr": pair_ptr,
        "pair_node": pair_node,
        "pair_slot": pair_slot,
        "tgt_ptr": tgt_ptr,
        "tgt_slot": tgt_slot,
        "tgt_uptr": tgt_uptr,
        "tgt_upd": tgt_upd,
        "fwd_ai": fwd_ai,
        "fwd_i": fwd_i,
        "fwd_out": fwd_out,
        "fin_ptr": fin_ptr,
        "fin_e": fin_e,
        "bwd_ia": bwd_ia,
        "bwd_a": cat([l.bwd_a for l in lv]),
        "bin_ptr": bin_ptr,
        "bin_e": bin_e,
        "row_ptr": np.searchsorted(slot_a[row_slot], np.arange(N + 1)),
        "row_slot": row_slot,
        "slot_b": slot_b,
    }
    real = _real_widths(sched, lane) if sched.width > 16 else {}
    arrays.update({k: real.get(k, []) for k in _ARRAYS[_ARRAYS.index("level_tw"):]})
    # the kernels keep diagonal blocks in slots 0..N-1 and stage the solve's
    # edge blocks as the slot range N..S-1
    if any(sched.slot[(n, n)] != n for n in range(N)):
        raise ValueError("the kernels need node n's diagonal block in slot n")
    if min(arrays["fwd_ai"].tolist() + arrays["bwd_ia"].tolist(), default=N) < N:
        raise ValueError("a solve edge reads a diagonal slot")
    return {k: np.asarray(v, dtype=np.int32) for k, v in arrays.items()}


def level_tile(w: int) -> int:
    """The tile a factorize level of real width w works at in the real-width
    classes: for w <= 32 w rounded up to 8, 16, 24 or 32 (csrc/ldu.cu
    level_tile; its groups are that many lanes up to 16, a warp above);
    above 32 (a wide level of the 33..72 class) w rounded up to odd, the
    row stride of its LU (cta_lu)."""
    return 8 if w <= 8 else 16 if w <= 16 else 24 if w <= 24 else 32 if w <= 32 else w | 1


ROW_CHUNK = 8  # rows of a target a Schur task of the 17..32 class forms (csrc/ldu.cu SROWS)


def wide_scratch(n: int, ld: int) -> int:
    """The scratch of a 33..72 CTA LU of width n at row stride ld, in
    elements (csrc/ldu.cu cta_lu): a ping-pong pair of n x ld arrays of
    rows, and two sets of the 8 warps' candidates' values and rows."""
    return 2 * n * ld + 32


def level_tiles(sched: Schedule) -> list:
    """The tile each level of the real-width factorize works at: its
    level_tile, unless the tiles of the levels up to 32 wide would switch
    more than once along them (snake, twister: 24, 8, 24, 8, ...), where
    each of those takes their widest.  Each tile is its own code, and a
    level that switches back runs it cold: on those schedules that cost the
    factorize more than the narrow levels save; the solve, whose code a tile
    is small, keeps each level's own (PERF.md §6).  A wide level (over 32)
    keeps its own."""
    tiles = [level_tile(int(lv.real_w)) for lv in sched.levels]
    narrow = [t for t in tiles if t <= 32]
    if sum(a != b for a, b in zip(narrow, narrow[1:])) <= 1:
        return tiles
    return [t if t > 32 else max(narrow) for t in tiles]


def _round4(n):
    return -(-n // 4) * 4


def _real_widths(sched: Schedule, lane: bool = False) -> dict:
    """The arrays of the 17..32 and 33..72 classes, at each node's real
    width (struct Sched, csrc/ldu.cu "factorize and solve, 17..32" and
    "factorize, 33..72"): ``level_tw``, the tile each factorize level works
    at (level_tiles; over 32 a wide level).

    Every slot (a, b) has its real widths in ``slot_rc`` (n_a << 8 | n_b)
    and a place in shared memory for its n_a real rows, W wide as in the
    blocks (``slot_off``, offsets in elements, each place rounded up to 4
    elements so that it starts 16-byte aligned; ``slot_off[S]`` is the
    total): one contiguous span of a block, staged and written back in
    16-byte pieces.  The factorize keeps each node's LU as a tile of its
    level's width (level_tile) at ``node_tile`` (each tile one element
    longer, so that the tiles of a level's nodes start in different banks)
    and its reciprocals and PS at ``node_tvec``; the solve stages each
    node's n real rows of LU and PS at ``node_lu`` and keeps its vectors of
    n at ``node_vec`` (all with the total last; the matvec finds a real row's
    node there).  Per level, its tasks: ``xtask`` (an X column: pair within
    the level << 7 | column) and ``stask`` (ROW_CHUNK rows of a target's
    column from a first row, or at a wide level one row: target within the
    level << 14 | first row << 7 | column), with their per-level offsets
    ``xtask_ptr`` / ``stask_ptr``.  What a task reads comes as records, so that it takes
    few dependent loads: ``pair_rec`` (per pair: E_{i,b}'s place, n_i << 8
    | n_b, node i's tile and vectors, the pair's X tile in its level's X
    tiles), ``tgt_rec`` (per target: its place and widths), ``upd_rec``
    (per update, in tgt_upd's order: E_{a,i}'s place, n_i, its pair's X
    tile), ``fin_rec`` / ``bin_rec`` (per solve edge, in fin_e / bin_e's
    order: the edge block's place among the edge blocks, the other node's
    vector offset (node x W), its width).

    ``lane``: the places are the blocks' own in a lane's tensors, slot s at
    s W² (``slot_off``) and node n's LU and PS at n W² (``node_lu``), for
    the kernels that keep a lane in global memory; every record follows."""
    nw = np.asarray(sched.node_width, dtype=np.int64)
    N, S, W = sched.n_nodes, sched.n_slots, sched.width
    slot_a = np.zeros(S, dtype=np.int64)
    slot_b = np.zeros(S, dtype=np.int64)
    for (a, b), s in sched.slot.items():
        slot_a[s], slot_b[s] = a, b
    size = lambda s: W * W if lane else _round4(int(nw[slot_a[s]]) * W)
    slot_off = np.cumsum([0] + [size(s) for s in range(S)])
    tiles = level_tiles(sched)
    tile = np.zeros(N, dtype=np.int64)
    for level, tw in zip(sched.levels, tiles):
        tile[level.nodes] = tw
    node_tile = np.cumsum([0] + (tile * tile + 1).tolist())
    node_tvec = np.cumsum([0] + tile.tolist())
    pair_rec, xtask, xtask_ptr, stask, stask_ptr, x_len = [], [], [0], [], [0], 0
    tgt_rec, upd_rec, u0 = [], [], 0
    for level, tw in zip(sched.levels, tiles):
        pairs = list(dict.fromkeys(zip(level.upd_inv.tolist(), level.upd_ib.tolist())))
        off, xoff = 0, {}
        for p, (i, ib) in enumerate(pairs):
            xoff[i, ib] = off
            pair_rec += [slot_off[ib], nw[i] << 8 | nw[slot_b[ib]], node_tile[i], node_tvec[i], off]
            off += _round4(tw * int(nw[slot_b[ib]]))
            xtask += [p << 7 | c for c in range(nw[slot_b[ib]])]
        tgts, _, grouped = _grouped(level.upd_tgt.tolist())
        rows = 1 if tw > 32 else ROW_CHUNK
        for t, tgt in enumerate(tgts):
            tgt_rec += [slot_off[tgt], nw[slot_a[tgt]] << 8 | nw[slot_b[tgt]]]
            stask += [t << 14 | r << 7 | c for r in range(0, int(nw[slot_a[tgt]]), rows)
                      for c in range(nw[slot_b[tgt]])]
        for k in grouped:  # the updates in tgt_upd's order
            ai, i, ib = int(level.upd_ai[k]), int(level.upd_inv[k]), int(level.upd_ib[k])
            upd_rec += [slot_off[ai], nw[i], xoff[i, ib]]
        x_len = max(x_len, off)
        if tw > 32:  # cta_lu's ping-pong rows and candidates lie in the X tiles' space
            x_len = max(x_len, wide_scratch(int(level.real_w), tw))
        xtask_ptr.append(len(xtask))
        stask_ptr.append(len(stask))
    e0 = slot_off[N]
    fwd = [(int(s), int(o)) for lv in sched.levels for s, o in zip(lv.fwd_ai, lv.fwd_i)]
    bwd = [(int(s), int(o)) for lv in sched.levels for s, o in zip(lv.bwd_ia, lv.bwd_a)]
    edge_rec = lambda edges, order: [v for e in order for v in (
        slot_off[edges[e][0]] - e0, edges[e][1] * W, nw[edges[e][1]])]
    fwd_a = np.concatenate([lv.fwd_a for lv in sched.levels]).tolist()
    bwd_i = np.concatenate([lv.bwd_i for lv in sched.levels]).tolist()
    return {
        "level_tw": tiles,
        "node_w": nw,
        "slot_rc": nw[slot_a] << 8 | nw[slot_b],
        "slot_off": slot_off,
        "node_tile": node_tile,
        "node_tvec": node_tvec,
        "pair_rec": pair_rec,
        "xtask_ptr": xtask_ptr,
        "xtask": xtask,
        "tgt_rec": tgt_rec,
        "upd_rec": upd_rec,
        "stask_ptr": stask_ptr,
        "stask": stask,
        "node_lu": np.cumsum([0] + [W * W if lane else _round4(int(n) * W) for n in nw]),
        "node_vec": np.cumsum([0] + nw.tolist()),
        "fin_rec": edge_rec(fwd, _grouped(fwd_a, N)[2]),
        "bin_rec": edge_rec(bwd, _grouped(bwd_i, N)[2]),
        "x_len": x_len,  # the most elements a level's X tiles (or a wide LU's scratch) take
                         # (not in the buffer)
    }


def _max_pairs(sched: Schedule) -> int:
    return max((len(set(zip(l.upd_inv.tolist(), l.upd_ib.tolist()))) for l in sched.levels),
               default=0)


def _max_nodes(sched: Schedule) -> int:
    return max(len(l.nodes) for l in sched.levels)


def _chunk(k: int, fixed: int, per_col: int, budget: int, most: int) -> int:
    """Columns a CTA takes of k: as many as fit ``budget`` bytes beside
    ``fixed`` at ``per_col`` a column (at most ``most``), spread evenly over
    the fewest CTAs; 0 if not one column fits."""
    kmax = min(most, (budget - fixed) // per_col)
    if kmax < 1:
        return 0
    chunks = -(-k // kmax)
    return -(-k // chunks)


def shared_chunk(sched: Schedule, kernel: str, dtype, k: int,
                 buf_len: int | None = None) -> int:
    """The columns a CTA of the kernels that share a lane's factors or
    blocks among its k right-hand sides takes of them: for ``kernel``
    "solve_shared" (W <= 16) at most SHARED_MAXKC (a lane of a warp each,
    in one CTA an SM), for "matvec" (every class) as many as fit two CTAs
    an SM where a lane's blocks leave room for a vector, else one.  Raises
    ValueError where not one column fits beside the factors."""
    cls = width_class(sched.width)
    if cls != "w16" and kernel != "matvec":
        raise ValueError(f"{kernel}: the shared-factor solve takes W <= 16")
    if buf_len is None:
        buf_len = sum(a.size for a in _csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    per_vec = sched.n_nodes * (16 if cls == "w16" else sched.width) * elem
    fixed = smem_layout(sched, kernel, dtype, buf_len, kc=0)["bytes"]
    if kernel == "solve_shared":  # b and t: two node vectors a column
        kc = _chunk(k, fixed, 2 * per_vec, SMEM_LIMIT, SHARED_MAXKC)
    elif kernel == "matvec":
        budget = SMEM_HALF if fixed + per_vec <= SMEM_HALF else SMEM_LIMIT
        kc = _chunk(k, fixed, per_vec, budget, k)
    else:
        raise ValueError(f"no shared-factor kernel {kernel!r}")
    if kc < 1:
        raise ValueError(f"{kernel}: the factors take {fixed} bytes of shared memory ({dtype}), "
                         f"no room for a column within the {SMEM_LIMIT}-byte limit of a CTA")
    return kc


def _real_sizes(sched: Schedule, kernel: str, elem: int, buf_len: int, kc: int = 1,
                lane: bool = False) -> dict:
    """The real-width kernels' shared-memory arrays (bytes), at real widths
    (``_real_widths``): the factorize (17..72) stages every slot's real
    rows, and keeps every node's LU tile, reciprocals and PS in compact form
    and one level's X tiles (or a wide node's two arrays of LU rows); the
    solve (17..72) stages the edge blocks' real rows, each node's real rows
    of LU and PS, and its node vectors at stride W; the matvec (17..72)
    stages every slot's real rows, ``kc`` node vectors at stride W and
    the schedule's index arrays it reads.  ``lane``: the kernels of a lane
    over a CTA, which keep the blocks (the solve: the edge blocks, LU and
    PS) in global memory: those arrays take no shared memory."""
    real = _real_widths(sched)
    big = 0 if lane else 1  # the arrays a lane over a CTA keeps in global memory
    off, N = real["slot_off"], sched.n_nodes
    a16 = lambda nbytes: -(-nbytes // 16) * 16  # each array 16-byte aligned
    if kernel == "factorize":
        tvec = int(real["node_tvec"][-1])
        return {
            "fb": big * a16(int(off[-1]) * elem),  # every slot's real rows
            "lu": a16(int(real["node_tile"][-1]) * elem),  # every node's LU tile
            "x": a16(real["x_len"] * elem),  # a level's X tiles
            "rd": a16(tvec * elem),  # 1 / diag(U) of every node
            "psc": a16(tvec * elem),  # their PS row scales
            "prow": a16(tvec * 4),  # their PS row sources
            "si": a16(buf_len * 4),  # the schedule
        }
    W = sched.width
    if kernel == "matvec":
        return {
            "blocks": big * a16(int(off[-1]) * elem),  # every slot's real rows
            "x": kc * N * W * elem,  # the chunk's vectors
            # row_ptr, row_slot, slot_b, slot_off, slot_rc, node_vec, node_w
            "idx": (4 * sched.n_slots + 3 * N + 3) * 4,
        }
    nlu, nvec = int(real["node_lu"][-1]), int(real["node_vec"][-1])
    return {
        "e": big * a16(int(off[-1] - off[N]) * elem),  # the edge blocks' real rows (N..S-1)
        "lu": big * a16(nlu * elem),  # each node's LU, its n real rows
        "rd": a16(nvec * elem),  # 1 / diag(U)
        "psc": a16(nvec * elem),  # PS row scales
        "b": a16(N * W * elem),  # right-hand side, at stride W
        "t": a16(N * W * elem),  # D^{-1} b of the forward pass
        "x": a16(N * W * elem),  # solution
        "y": 0,
        "ps": big * a16(nlu * elem),  # each node's PS, its n real rows, as staged
        "prow": a16(nvec * 4),  # PS row sources
        "si": a16(buf_len * 4),  # the schedule
    }


def smem_layout(sched: Schedule, kernel: str, dtype, buf_len: int | None = None,
                kc: int = 1) -> dict:
    """The shared memory of one CTA of ``kernel``: the byte offset of each
    array (csrc/ldu.cu FactLayout / SolveLayout; for the matvecs, the
    vectors' offset ``x``), and the CTA's dynamic shared memory in all
    (``bytes``).  "factorize" and "solve" take one lane (and one vector);
    "solve_shared" (W <= 16) and "matvec" one factorization and ``kc`` of
    its right-hand sides.  ``buf_len`` is the length of the schedule's
    int32 CSR buffer, copied to shared memory.  Tiles are padded to
    ``tile_width`` of the schedule's width class (W <= 16), or each node
    kept at its real rows (``_real_sizes``: the kernels of 17..72).  Where a
    lane of 17..72 at its real rows takes more than a CTA can have (one
    vector: kc = 1), the layout is that of the kernels that keep the lane in
    global memory (csrc/ldu_lane.cu: ``lane_variant``).  Raises ValueError
    for a CTA over the 227 KB it can have."""
    if buf_len is None:
        buf_len = sum(a.size for a in _csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    cls = width_class(sched.width)
    TW = 0 if cls == "w32" else tile_width(sched.width)
    NGROUPS = WIDTH_CLASSES[cls][1]
    N, S, WW, TILE = sched.n_nodes, sched.n_slots, sched.width**2, TW * TW
    lane = lane_variant(sched, kernel, dtype, buf_len)
    if cls != "w16" and kernel in ("factorize", "solve", "matvec"):
        sizes = _real_sizes(sched, kernel, elem, buf_len, kc, lane)
    elif kernel == "factorize":
        K = _max_nodes(sched)
        sizes = {
            "fb": S * WW * elem,  # the lane's blocks, factored in place
            "lu": K * TILE * elem,  # LU tiles of one level's nodes
            "x": _max_pairs(sched) * TILE * elem,  # X tiles of one level's pairs
            "rd": K * TW * elem,  # 1 / diag(U) of those nodes
            "psc": K * TW * elem,  # their PS row scales
            "prow": K * TW * 4,  # their PS row sources
            "si": buf_len * 4,  # the schedule
        }
    elif kernel == "solve":
        sizes = {
            "e": (S - N) * WW * elem,  # the edge blocks (slots N..S-1)
            "lu": N * TILE * elem,  # LU tiles
            "rd": N * TW * elem,  # 1 / diag(U)
            "psc": N * TW * elem,  # PS row scales
            "b": N * TW * elem,  # right-hand side
            "t": N * TW * elem,  # D^{-1} b of the forward pass
            "x": N * TW * elem,  # solution
            "y": NGROUPS * TW * elem,  # PS·b of each group's node
            "ps": 0,
            "prow": N * TW * 4,  # PS row sources
            "si": buf_len * 4,  # the schedule
        }
    elif kernel == "solve_shared":
        if width_class(sched.width) != "w16":
            raise ValueError("the shared-factor solve takes W <= 16")
        sizes = {
            "e": (S - N) * TILE * elem,  # the edge blocks (slots N..S-1) as 16 x 16 tiles
            "lu": N * TILE * elem,  # LU tiles
            "rd": N * TW * elem,  # 1 / diag(U)
            "psc": N * TW * elem,  # PS row scales
            "b": N * TW * kc * elem,  # right-hand sides, column-minor
            "t": N * TW * kc * elem,  # D^{-1} b of the forward pass, then the solution
            "x": 0,
            "y": 0,
            "ps": 0,
            "prow": N * TW * 4,  # PS row sources
            "si": buf_len * 4,  # the schedule
        }
    elif kernel == "matvec":
        sizes = {
            "blocks": -(-S * WW * elem // 16) * 16,  # the lane's blocks
            "x": kc * N * TW * elem,  # the chunk's vectors, padded to 16 a node
        }
    else:
        raise ValueError(f"no shared-memory layout for kernel {kernel!r}")
    offsets = dict(zip(sizes, np.cumsum([0, *sizes.values()]).tolist()))
    offsets["bytes"] = sum(sizes.values())
    if offsets["bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"{kernel}: one lane needs {offsets['bytes']} bytes of shared memory ({dtype}), "
            f"over the {SMEM_LIMIT}-byte limit of a CTA"
            + (" with its blocks in global memory" if lane else "")
        )
    return offsets


def lane_variant(sched: Schedule, kernel: str, dtype, buf_len: int | None = None) -> bool:
    """Whether ``kernel`` (factorize, solve or matvec) takes the kernels of
    a lane over a CTA (csrc/ldu_lane.cu) for this schedule and dtype: a
    schedule of 17..72 whose lane at its real rows, with one vector, takes
    more shared memory than a CTA can have."""
    if width_class(sched.width) == "w16" or kernel not in ("factorize", "solve", "matvec"):
        return False
    if buf_len is None:
        buf_len = sum(a.size for a in _csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    return sum(_real_sizes(sched, kernel, elem, buf_len).values()) > SMEM_LIMIT


def variant(sched: Schedule, kernel: str, dtype, buf_len: int | None = None) -> str:
    """The kernels a launch of ``kernel`` (factorize, solve or matvec, one
    right-hand side a factorization) takes for this schedule and dtype: its
    width class, or "lane" where the lane does not fit a CTA."""
    return "lane" if lane_variant(sched, kernel, dtype, buf_len) else width_class(sched.width)


def _device_csr(sched: Schedule, device, lane: bool = False):
    """``_csr(sched, lane)`` as one int32 buffer on ``device`` and the C
    struct Sched that points into it: (buffer, struct)."""
    arrays = _csr(sched, lane)
    buf = torch.as_tensor(np.concatenate([arrays[n] for n in _ARRAYS]),
                          device=torch.device(device))
    offs = np.cumsum([0] + [arrays[n].size for n in _ARRAYS])
    base = buf.data_ptr()
    return buf, _Sched(len(sched.levels), sched.n_nodes, sched.n_slots, sched.width,
                       *(base + 4 * int(o) for o in offs[:-1]), base, buf.numel())


class DeviceSchedule:
    """An elimination schedule on one device: the plain version's index
    tensors (``plan``) and the kernels' int32 CSR buffer with its C struct."""

    def __init__(self, sched: Schedule, device):
        self.sched = sched
        self.plan = ldu.LduPlan(sched, device)
        self.buf, self.struct = _device_csr(sched, device)
        self._layouts = {}
        self._lane = None

    def lane_struct(self):
        """The C struct of the schedule for the kernels of a lane over a CTA
        (``_csr(sched, lane=True)``: slot s at s W², node n's LU and PS at
        n W²), on this device, made at first use (its buffer kept with it)."""
        if self._lane is None:
            self._lane = _device_csr(self.sched, self.buf.device, lane=True)
        return self._lane[1]

    def layout(self, kernel: str, dtype, kc: int = 1):
        """``smem_layout`` of this schedule as its C struct (for "matvec":
        the offsets dict), made once per kernel, dtype and kc."""
        key = kernel, dtype, kc
        if key not in self._layouts:
            offsets = smem_layout(self.sched, kernel, dtype, self.buf.numel(), kc)
            struct = _LAYOUT_STRUCTS.get(kernel)
            self._layouts[key] = (struct(*(offsets[n] for n, _ in struct._fields_))
                                  if struct else offsets)
        return self._layouts[key]

    def lane(self, kernel: str, dtype) -> bool:
        """``lane_variant`` of this schedule, made once per kernel and dtype."""
        key = "lane", kernel, dtype
        if key not in self._layouts:
            self._layouts[key] = lane_variant(self.sched, kernel, dtype, self.buf.numel())
        return self._layouts[key]

    def chunk(self, kernel: str, dtype, k: int) -> int:
        """``shared_chunk`` of this schedule, made once per kernel, dtype and k."""
        key = "chunk", kernel, dtype, k
        if key not in self._layouts:
            self._layouts[key] = shared_chunk(self.sched, kernel, dtype, k, self.buf.numel())
        return self._layouts[key]


def _cuda_args(ds: DeviceSchedule, rhs_per_fact=1, **tensors):
    """Validate CUDA inputs of one launch; returns (fn suffix, B, device).

    B is the lane count of the first tensor (blocks, or the factors); node
    vectors ``x`` hold ``rhs_per_fact`` lanes for each of those B.  Raises
    for a block width no kernel takes."""
    sched = ds.sched
    N, S, W = sched.n_nodes, sched.n_slots, sched.width
    width_class(W)
    expect = {"blocks": (S, W, W), "lu": (N, W, W), "ps": (N, W, W), "x": (N, W)}
    first = next(iter(tensors.values()))
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"LDU kernels take float32 or float64, got {first.dtype}")
    if ds.buf.device != first.device:
        raise ValueError(f"schedule on {ds.buf.device}, tensors on {first.device}")
    if not isinstance(rhs_per_fact, int) or rhs_per_fact < 1:
        raise ValueError(f"rhs_per_fact must be a positive int, got {rhs_per_fact!r}")
    B = first.shape[0]
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype} differs from {first.device}/{first.dtype}")
        lanes = B * rhs_per_fact if name == "x" else B
        if tuple(t.shape) != (lanes, *expect[name]):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(lanes, *expect[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous tensors")
    suffix = "f32" if first.dtype == torch.float32 else "f64"
    return suffix, B, first.device


def _launch(wrapper, suffix, ds, device, k, lane, *args):
    """Launch ldu_<name>_<suffix> (the kernel of the schedule's width class)
    or, with ``lane``, ldu_lane_<name>_<suffix> (csrc/ldu_lane.cu, on the
    schedule's lane struct) on the device's current stream, and count it on
    its wrapper (with k > 1 right-hand sides a factorization also in
    ``shared_launches``)."""
    name, elem = wrapper.__name__, 4 if suffix == "f32" else 8
    fn = getattr(lane_library(elem), f"ldu_lane_{name}_{suffix}") if lane else getattr(
        library(elem=elem), f"ldu_{name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.byref(ds.lane_struct() if lane else ds.struct), *args, stream)
    if rc != 0:
        raise RuntimeError(f"ldu_{'lane_' if lane else ''}{name}_{suffix}: CUDA error {rc}")
    cls = "lane" if lane else width_class(ds.sched.width)
    wrapper.launches += 1
    wrapper.class_launches[cls] += 1
    if k > 1:
        wrapper.shared_launches[cls] += 1


def _plain_or_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"LDU: no kernel for device {t.device}")


def factorize(ds: DeviceSchedule, blocks: torch.Tensor):
    """Block-LU factorization → (factored blocks, LU, PS).

    Replaces fact_kernel / factorize_b (dojo_tpu/pallas_ldu.py:189, :223).
    Bound on the card: each lane's dependency chain (8 levels on the
    quadruped, each a 14-pivot block LU, an X solve and the Schur
    products), not its ~50 MB of traffic at B=256.
    Design: one CTA per lane, the lane's blocks and the schedule in shared
    memory (staged by cp.async, outputs written once); a level's node LUs
    run at once, a half-warp per node with its rows in registers, pivoting
    by shuffles without moving rows; X = D_i⁻¹E_{i,b} once per distinct
    pair, then each target block reduced by one half-warp in list order.
    Three CTA barriers per level.  17 <= W <= 72: at each node's real
    width (each block staged as its real rows, a level's LUs in groups of
    8 or 16 lanes or a warp, X a thread per column, the targets a thread
    per column and 8 rows, LU and PS written at the end), the pad of the
    blocks taken as the assembler makes it (zero, identity on the diagonal
    blocks); 33 <= W <= 72, a node wider than 32: its block LU by the whole
    CTA (its trailing submatrix in the registers of 256 threads, each
    warp's pivot candidate taken from them, one CTA barrier per pivot), X
    a warp per column, the targets a thread per entry.  Rows swap arithmetically, as in
    ldu.blu_factor; every block LU is ldu.blu_factor's bitwise."""
    if not _plain_or_cuda(blocks):
        return ldu.factorize(ds.plan, blocks)
    suffix, B, dev = _cuda_args(ds, blocks=blocks)
    layout = ds.layout("factorize", blocks.dtype)
    N, W = ds.sched.n_nodes, ds.sched.width
    fb = torch.empty_like(blocks)
    lu = blocks.new_empty(B, N, W, W)
    ps = blocks.new_empty(B, N, W, W)
    if B:
        _launch(factorize, suffix, ds, dev, 1, ds.lane("factorize", blocks.dtype),
                ctypes.byref(layout), B,
                blocks.data_ptr(), fb.data_ptr(), lu.data_ptr(), ps.data_ptr())
    return fb, lu, ps


def solve(ds: DeviceSchedule, fact, rhs: torch.Tensor, rhs_per_fact: int = 1) -> torch.Tensor:
    """Two-pass block backsubstitution on node vectors (B·k, N, W) against
    the factorization of B lanes, k = ``rhs_per_fact``: right-hand side l
    is solved with the factors of lane l // k, which are read in place (no
    copy per right-hand side).

    Replaces solve_kernel / _call_solve (dojo_tpu/pallas_ldu.py:286, :304).
    Bound on the card: each lane's dependency chain of 2×8 level passes,
    each a W-step substitution; the data (edge blocks, LU, PS) is read once.
    Design: one CTA per lane with the edge blocks, LU tiles, PS (in compact
    form) and the schedule in shared memory; a half-warp per node of a
    level pulls the edge contributions to its node in list order, gathers
    PS·b, and one lane substitutes with the node's LU in registers.  One
    CTA barrier per level pass.  17 <= W <= 72: at each node's real width
    (edge blocks, LU and PS staged at their real size, each edge's row dot
    over the other node's real terms), the node's group substituting with
    y_i in lane i, two steps a shuffle round; a node wider than 32 (33 <=
    W <= 72) by the warps that hold its rows, a thread a row, a named
    barrier a row (ldu.blu_solve's order; the card may contract a product
    and its difference into one FMA).  The real-width
    classes take the pad of the factors and of the blocks that made them
    as the assembler makes it (zero, identity on the diagonal blocks: LU's
    and PS's pad identity, the edge blocks' zero); a solution's pad is then
    the right-hand side's, which the kernel copies.  With k > 1 and
    W <= 16: one CTA per factorization and chunk of up to 32 of its
    columns, the factors staged once, a warp a node and a lane a column."""
    fb, lu, ps = fact
    if not _plain_or_cuda(rhs):
        return ldu.solve(ds.plan, fact, rhs, rhs_per_fact)
    suffix, B, dev = _cuda_args(ds, rhs_per_fact, blocks=fb, lu=lu, ps=ps, x=rhs)
    k, kc = rhs_per_fact, 0
    if k > 1 and width_class(ds.sched.width) == "w16":
        kc = ds.chunk("solve_shared", rhs.dtype, k)
        layout = ds.layout("solve_shared", rhs.dtype, kc)
    else:
        layout = ds.layout("solve", rhs.dtype)
    out = torch.empty_like(rhs)
    if B:
        lane = kc == 0 and ds.lane("solve", rhs.dtype)
        _launch(solve, suffix, ds, dev, k, lane, ctypes.byref(layout), B, k,
                *(() if lane else (kc,)), fb.data_ptr(), lu.data_ptr(), ps.data_ptr(),
                rhs.data_ptr(), out.data_ptr())
    return out


def matvec(ds: DeviceSchedule, blocks: torch.Tensor, x: torch.Tensor,
           rhs_per_fact: int = 1) -> torch.Tensor:
    """Exact block product y[a] = Σ_{slots (a,b)} block·x[b], node vectors
    (B·k, N, W) against blocks (B, S, W, W), k = ``rhs_per_fact``: vector l
    is multiplied by the blocks of lane l // k.

    Replaces matvec_kernel / _call_matvec (dojo_tpu/pallas_ldu.py:292, :321).
    Bound on the card: reading the (B, S, W, W) blocks once (bytes).
    Design: W <= 16, one CTA per lane and chunk of its k vectors, the
    lane's blocks and the chunk's vectors staged once in shared memory,
    coalesced, a thread an output row for up to 6 vectors; 17 <= W <= 72,
    the same with each block staged as its real rows, a thread a real
    output row of one vector over its real terms, the blocks' pad taken as
    the assembler makes it (zero, identity on the diagonal blocks: a pad
    row of the output is the vector's own entry).  A row sums its node's
    slots in slot order."""
    if not _plain_or_cuda(x):
        return ldu.matvec(ds.plan, blocks, x, rhs_per_fact)
    suffix, B, dev = _cuda_args(ds, rhs_per_fact, blocks=blocks, x=x)
    k = rhs_per_fact
    kc = ds.chunk("matvec", x.dtype, k)
    layout = ds.layout("matvec", x.dtype, kc)
    out = torch.empty_like(x)
    if B:
        _launch(matvec, suffix, ds, dev, k, ds.lane("matvec", x.dtype), B, k, kc, layout["x"],
                layout["bytes"], blocks.data_ptr(), x.data_ptr(), out.data_ptr())
    return out


def solve_refine(ds: DeviceSchedule, blocks, fact, rhs: torch.Tensor, n_ref: int,
                 rhs_per_fact: int = 1):
    """Solve, then ``n_ref`` × (matvec, solve) iterative-refinement sweeps —
    the order of dojo_tpu/pallas_ldu.py solve_b."""
    k = rhs_per_fact
    x = solve(ds, fact, rhs, k)
    for _ in range(n_ref):
        x = x + solve(ds, fact, rhs - matvec(ds, blocks, x, k), k)
    return x


def reset_launches():
    """Set every wrapper's launch counts to 0."""
    for fn in (factorize, solve, matvec):
        fn.launches = 0
        fn.class_launches = dict.fromkeys(VARIANTS, 0)
        fn.shared_launches = dict.fromkeys(VARIANTS, 0)


reset_launches()
