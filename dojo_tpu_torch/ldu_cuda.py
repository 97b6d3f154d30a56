"""The three block-LDU kernels (csrc/ldu.cu) and their wrappers.

Each wrapper takes the plain PyTorch version (ldu.py) for a tensor on the
CPU, at any block width, and launches the CUDA kernel for a tensor on a
CUDA device; a CUDA tensor the kernels cannot take (W > MAXW = 72, a lane
over the shared-memory limit of a CTA (``smem_layout``), not contiguous,
not float32/float64, not (B, ...) batch-major) raises.  There is no
fallback.

The kernels come in three width classes (``WIDTH_CLASSES``), each a kernel
of its own picked from the schedule's block width W: W <= 16 (a half-warp
per block, tiles padded to 16), 17..32 (a warp per block, tiles padded to
W rounded up to a multiple of 8) and 33..72 (the whole CTA per block, a
thread per row, tiles of W).  Each wrapper counts its kernel launches in
``<wrapper>.launches`` (a plain integer, all classes) and per class in
``<wrapper>.class_launches``.

The library is built at first use with nvcc for sm_90a into ``_build/``
(listed in .gitignore), keyed on a hash of the source and flags, and loaded
with ctypes: a plain C interface, no PyTorch headers, seconds to compile.
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


def width_class(W: int) -> str:
    """The kernels' class for block width W (raises for W > MAXW)."""
    for name, (widest, _) in WIDTH_CLASSES.items():
        if W <= widest:
            return name
    raise ValueError(f"block width {W} exceeds the kernels' MAXW={MAXW}")


def tile_width(W: int) -> int:
    """The padded width of a W x W tile in shared memory (csrc/ldu.cu
    ldu_tile): 16 for W <= 16, W rounded up to a multiple of 8 up to 32,
    W itself above."""
    cls = width_class(W)
    return 16 if cls == "w16" else -(-W // 8) * 8 if cls == "w32" else W

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ldu.cu")
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
)
SMEM_LIMIT = 232448  # dynamic shared memory one CTA may opt into on sm_90 (227 KB)


class _Sched(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _INTS] + [
        (n, ctypes.c_void_p) for n in _ARRAYS
    ] + [("buf", ctypes.c_void_p), ("buf_len", ctypes.c_int)]


class _FactLayout(ctypes.Structure):  # C struct FactLayout (see smem_layout)
    _fields_ = [(n, ctypes.c_int)
                for n in ("fb", "lu", "x", "rd", "psc", "red", "prow", "si", "bytes")]


class _SolveLayout(ctypes.Structure):  # C struct SolveLayout (see smem_layout)
    _fields_ = [(n, ctypes.c_int)
                for n in ("e", "lu", "rd", "psc", "b", "t", "x", "y", "prow", "si", "bytes")]


_LAYOUT_STRUCTS = {"factorize": _FactLayout, "solve": _SolveLayout}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")
    return path


def build() -> tuple[str, str]:
    """Compile csrc/ldu.cu into a shared library unless a build of the same
    source and flags exists.  Returns (library path, ptxas report: each
    kernel's registers, spills and shared memory)."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libdojo_ldu_{key}.so")
    log = lib + ".ptxas.txt"
    if os.path.exists(lib):
        return lib, open(log).read() if os.path.exists(log) else ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
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


_LIBS: dict = {}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded once per process."""
    if "lib" not in _LIBS:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "f64"):
            getattr(lib, f"ldu_factorize_{dt}").argtypes = [p, p, i, p, p, p, p, p]
            getattr(lib, f"ldu_solve_{dt}").argtypes = [p, p, i, i, p, p, p, p, p, p]
            getattr(lib, f"ldu_matvec_{dt}").argtypes = [p, i, i, p, p, p, p]
            for fn in ("factorize", "solve", "matvec"):
                getattr(lib, f"ldu_{fn}_{dt}").restype = i
        lib.ldu_max_width.restype = i
        lib.ldu_tile.argtypes = [i]
        lib.ldu_tile.restype = i
        lib.ldu_kernel_smem.argtypes = [i, i, i]
        lib.ldu_kernel_smem.restype = i
        if lib.ldu_max_width() != MAXW:
            raise RuntimeError("csrc/ldu.cu's widest block differs from ldu_cuda.MAXW")
        if any(lib.ldu_tile(W) != tile_width(W) for W in range(1, MAXW + 1)):
            raise RuntimeError("csrc/ldu.cu ldu_tile differs from ldu_cuda.tile_width")
        _LIBS["lib"] = lib
    return _LIBS["lib"]


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


def _csr(sched: Schedule) -> dict:
    """The schedule's lists as int32 arrays in CSR form (see struct Sched).

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
    # the kernels keep diagonal blocks in slots 0..N-1 and stage the solve's
    # edge blocks as the slot range N..S-1
    if any(sched.slot[(n, n)] != n for n in range(N)):
        raise ValueError("the kernels need node n's diagonal block in slot n")
    if min(arrays["fwd_ai"].tolist() + arrays["bwd_ia"].tolist(), default=N) < N:
        raise ValueError("a solve edge reads a diagonal slot")
    return {k: np.asarray(v, dtype=np.int32) for k, v in arrays.items()}


def _max_pairs(sched: Schedule) -> int:
    return max((len(set(zip(l.upd_inv.tolist(), l.upd_ib.tolist()))) for l in sched.levels),
               default=0)


def _max_nodes(sched: Schedule) -> int:
    return max(len(l.nodes) for l in sched.levels)


def smem_layout(sched: Schedule, kernel: str, dtype, buf_len: int | None = None) -> dict:
    """The shared memory of one CTA (one lane) of ``kernel``: the byte
    offset of each array (csrc/ldu.cu FactLayout / SolveLayout), and the
    CTA's dynamic shared memory in all (``bytes``).  ``buf_len`` is the
    length of the schedule's int32 CSR buffer, copied to shared memory.
    Tiles are padded to ``tile_width`` of the schedule's width class.
    Raises ValueError for a schedule whose lane does not fit the 227 KB a
    CTA can have."""
    if buf_len is None:
        buf_len = sum(a.size for a in _csr(sched).values())
    elem = torch.empty((), dtype=dtype).element_size()
    TW = tile_width(sched.width)
    NGROUPS = WIDTH_CLASSES[width_class(sched.width)][1]
    N, S, WW, TILE = sched.n_nodes, sched.n_slots, sched.width**2, TW * TW
    if kernel == "factorize":
        K = _max_nodes(sched)
        sizes = {
            "fb": S * WW * elem,  # the lane's blocks, factored in place
            "lu": K * TILE * elem,  # LU tiles of one level's nodes
            "x": _max_pairs(sched) * TILE * elem,  # X tiles of one level's pairs
            "rd": K * TW * elem,  # 1 / diag(U) of those nodes
            "psc": K * TW * elem,  # their PS row scales
            # the 33..72 class's pivot search: 2 x 4 warp winners and keys
            "red": (8 * elem + 32) if width_class(sched.width) == "w72" else 0,
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
            "prow": N * TW * 4,  # PS row sources
            "si": buf_len * 4,  # the schedule
        }
    else:
        raise ValueError(f"no shared-memory layout for kernel {kernel!r}")
    offsets = dict(zip(sizes, np.cumsum([0, *sizes.values()]).tolist()))
    offsets["bytes"] = sum(sizes.values())
    if offsets["bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"{kernel}: one lane needs {offsets['bytes']} bytes of shared memory ({dtype}), "
            f"over the {SMEM_LIMIT}-byte limit of a CTA"
        )
    return offsets


class DeviceSchedule:
    """An elimination schedule on one device: the plain version's index
    tensors (``plan``) and the kernels' int32 CSR buffer with its C struct."""

    def __init__(self, sched: Schedule, device):
        self.sched = sched
        self.plan = ldu.LduPlan(sched, device)
        arrays = _csr(sched)
        self.buf = torch.as_tensor(
            np.concatenate([arrays[n] for n in _ARRAYS]), device=torch.device(device)
        )
        offs = np.cumsum([0] + [arrays[n].size for n in _ARRAYS])
        base = self.buf.data_ptr()
        self.struct = _Sched(
            len(sched.levels), sched.n_nodes, sched.n_slots, sched.width,
            *(base + 4 * int(o) for o in offs[:-1]), base, self.buf.numel(),
        )
        self._layouts = {}

    def layout(self, kernel: str, dtype):
        """``smem_layout`` of this schedule as its C struct, made once per
        kernel and dtype."""
        if (kernel, dtype) not in self._layouts:
            offsets = smem_layout(self.sched, kernel, dtype, self.buf.numel())
            struct = _LAYOUT_STRUCTS[kernel]
            self._layouts[kernel, dtype] = struct(*(offsets[n] for n, _ in struct._fields_))
        return self._layouts[kernel, dtype]


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


def _launch(wrapper, suffix, ds, device, *args):
    """Launch ldu_<name>_<suffix> (the kernel of the schedule's width class)
    on the device's current stream, and count it on its wrapper."""
    name = wrapper.__name__
    fn = getattr(library(), f"ldu_{name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.byref(ds.struct), *args, stream)
    if rc != 0:
        raise RuntimeError(f"ldu_{name}_{suffix}: CUDA error {rc}")
    wrapper.launches += 1
    wrapper.class_launches[width_class(ds.sched.width)] += 1


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
    Three CTA barriers per level.  17 <= W <= 32: the same with a warp per
    node; 33 <= W <= 72: the CTA on one node at a time, a thread per row,
    one CTA barrier per pivot."""
    if not _plain_or_cuda(blocks):
        return ldu.factorize(ds.plan, blocks)
    suffix, B, dev = _cuda_args(ds, blocks=blocks)
    layout = ds.layout("factorize", blocks.dtype)
    N, W = ds.sched.n_nodes, ds.sched.width
    fb = torch.empty_like(blocks)
    lu = blocks.new_empty(B, N, W, W)
    ps = blocks.new_empty(B, N, W, W)
    if B:
        _launch(factorize, suffix, ds, dev, ctypes.byref(layout), B,
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
    CTA barrier per level pass.  17 <= W <= 32: the same with a warp per
    node; 33 <= W <= 72: the CTA on one node at a time, a thread per row,
    one CTA barrier per substitution step."""
    fb, lu, ps = fact
    if not _plain_or_cuda(rhs):
        return ldu.solve(ds.plan, fact, rhs, rhs_per_fact)
    suffix, B, dev = _cuda_args(ds, rhs_per_fact, blocks=fb, lu=lu, ps=ps, x=rhs)
    layout = ds.layout("solve", rhs.dtype)
    out = torch.empty_like(rhs)
    if B:
        _launch(solve, suffix, ds, dev, ctypes.byref(layout), B * rhs_per_fact, rhs_per_fact,
                fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), rhs.data_ptr(), out.data_ptr())
    return out


def matvec(ds: DeviceSchedule, blocks: torch.Tensor, x: torch.Tensor,
           rhs_per_fact: int = 1) -> torch.Tensor:
    """Exact block product y[a] = Σ_{slots (a,b)} block·x[b], node vectors
    (B·k, N, W) against blocks (B, S, W, W), k = ``rhs_per_fact``: vector l
    is multiplied by the blocks of lane l // k.

    Replaces matvec_kernel / _call_matvec (dojo_tpu/pallas_ldu.py:292, :321).
    Bound on the card: reading the (B, S, W, W) blocks once (bytes).
    Design: one CTA per lane, x in shared memory, one thread per output
    row summing its node's slots in slot order."""
    if not _plain_or_cuda(x):
        return ldu.matvec(ds.plan, blocks, x, rhs_per_fact)
    suffix, B, dev = _cuda_args(ds, rhs_per_fact, blocks=blocks, x=x)
    out = torch.empty_like(x)
    if B:
        _launch(matvec, suffix, ds, dev, B * rhs_per_fact, rhs_per_fact,
                blocks.data_ptr(), x.data_ptr(), out.data_ptr())
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
        fn.class_launches = dict.fromkeys(WIDTH_CLASSES, 0)


reset_launches()
