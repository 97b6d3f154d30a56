"""The three block-LDU kernels (csrc/ldu.cu) and their wrappers.

Each wrapper takes the plain PyTorch version (ldu.py) for a tensor on the
CPU and launches the CUDA kernel for a tensor on a CUDA device; a CUDA
tensor the kernel cannot take (W > 16, not contiguous, not float32/float64,
not (B, ...) batch-major) raises.  There is no fallback.  Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (a plain integer).

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

MAXW = 16  # compile-time bound on the block width (csrc/ldu.cu MAXW)
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ldu.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# C struct Sched: 4 ints, then these device pointers, in this order
_ARRAYS = (
    "level_ptr", "level_nodes", "level_w",
    "upd_ptr", "upd_ai", "upd_inv", "upd_ib", "upd_tgt",
    "fwd_ptr", "fwd_i", "fwd_ai", "fwd_a",
    "bwd_ptr", "bwd_ia", "bwd_a", "bwd_i",
    "row_ptr", "row_slot", "slot_b",
)


class _Sched(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("n_levels", "n_nodes", "n_slots", "width")] + [
        (n, ctypes.c_void_p) for n in _ARRAYS
    ]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")
    return path


def build() -> tuple[str, str]:
    """Compile csrc/ldu.cu into a shared library unless a build of the same
    source and flags exists.  Returns (library path, compiler report)."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libdojo_ldu_{key}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
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
            getattr(lib, f"ldu_factorize_{dt}").argtypes = [p, i, p, p, p, p, p]
            getattr(lib, f"ldu_solve_{dt}").argtypes = [p, i, p, p, p, p, p, p]
            getattr(lib, f"ldu_matvec_{dt}").argtypes = [p, i, p, p, p, p]
            for fn in ("factorize", "solve", "matvec"):
                getattr(lib, f"ldu_{fn}_{dt}").restype = i
        lib.ldu_max_width.restype = i
        if lib.ldu_max_width() != MAXW:
            raise RuntimeError("csrc/ldu.cu MAXW differs from ldu_cuda.MAXW")
        _LIBS["lib"] = lib
    return _LIBS["lib"]


def _csr(sched: Schedule) -> dict:
    """The schedule's lists as int32 arrays in CSR form (see struct Sched)."""
    ptr = lambda lists: np.cumsum([0] + [len(x) for x in lists])
    cat = lambda lists: np.concatenate([np.asarray(x, dtype=np.int64) for x in lists] or [[]])
    lv = sched.levels
    slot_a = np.zeros(sched.n_slots, dtype=np.int64)
    slot_b = np.zeros(sched.n_slots, dtype=np.int64)
    for (a, b), s in sched.slot.items():
        slot_a[s], slot_b[s] = a, b
    row_slot = np.argsort(slot_a, kind="stable")
    arrays = {
        "level_ptr": ptr([l.nodes for l in lv]),
        "level_nodes": cat([l.nodes for l in lv]),
        "level_w": np.asarray([l.real_w for l in lv]),
        "upd_ptr": ptr([l.upd_tgt for l in lv]),
        "upd_ai": cat([l.upd_ai for l in lv]),
        "upd_inv": cat([l.upd_inv for l in lv]),
        "upd_ib": cat([l.upd_ib for l in lv]),
        "upd_tgt": cat([l.upd_tgt for l in lv]),
        "fwd_ptr": ptr([l.fwd_a for l in lv]),
        "fwd_i": cat([l.fwd_i for l in lv]),
        "fwd_ai": cat([l.fwd_ai for l in lv]),
        "fwd_a": cat([l.fwd_a for l in lv]),
        "bwd_ptr": ptr([l.bwd_i for l in lv]),
        "bwd_ia": cat([l.bwd_ia for l in lv]),
        "bwd_a": cat([l.bwd_a for l in lv]),
        "bwd_i": cat([l.bwd_i for l in lv]),
        "row_ptr": np.searchsorted(slot_a[row_slot], np.arange(sched.n_nodes + 1)),
        "row_slot": row_slot,
        "slot_b": slot_b,
    }
    return {k: np.asarray(v, dtype=np.int32) for k, v in arrays.items()}


class DeviceSchedule:
    """An elimination schedule on one device: the plain version's index
    tensors (``plan``) and the kernels' int32 CSR buffer with its C struct."""

    def __init__(self, sched: Schedule, device):
        if sched.width > MAXW:
            raise ValueError(f"block width {sched.width} exceeds the kernels' MAXW={MAXW}")
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
            *(base + 4 * int(o) for o in offs[:-1]),
        )


def _cuda_args(ds: DeviceSchedule, **tensors):
    """Validate CUDA inputs of one launch; returns (fn suffix, B, device)."""
    sched = ds.sched
    N, S, W = sched.n_nodes, sched.n_slots, sched.width
    expect = {"blocks": (S, W, W), "lu": (N, W, W), "ps": (N, W, W), "x": (N, W)}
    first = next(iter(tensors.values()))
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"LDU kernels take float32 or float64, got {first.dtype}")
    if ds.buf.device != first.device:
        raise ValueError(f"schedule on {ds.buf.device}, tensors on {first.device}")
    B = first.shape[0]
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype} differs from {first.device}/{first.dtype}")
        if tuple(t.shape) != (B, *expect[name]):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(B, *expect[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous tensors")
    suffix = "f32" if first.dtype == torch.float32 else "f64"
    return suffix, B, first.device


def _launch(name, suffix, ds, B, device, *ptrs):
    """Launch ldu_<name>_<suffix> on the device's current stream."""
    fn = getattr(library(), f"ldu_{name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.byref(ds.struct), B, *ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"ldu_{name}_{suffix}: CUDA error {rc}")


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
    Bound on the card: the sequential elimination chain (8 levels, 14
    pivots per node, 61 Schur updates on the quadruped, each a
    __syncthreads() round of one CTA), not its ~50 MB of traffic at B=256.
    Design: one CTA per lane, a 16x16 thread tile per W×W block, the
    working block in shared memory, updates in list order."""
    if not _plain_or_cuda(blocks):
        return ldu.factorize(ds.plan, blocks)
    suffix, B, dev = _cuda_args(ds, blocks=blocks)
    N, W = ds.sched.n_nodes, ds.sched.width
    fb = torch.empty_like(blocks)
    lu = blocks.new_empty(B, N, W, W)
    ps = blocks.new_empty(B, N, W, W)
    if B:
        _launch("factorize", suffix, ds, B, dev,
                blocks.data_ptr(), fb.data_ptr(), lu.data_ptr(), ps.data_ptr())
        factorize.launches += 1
    return fb, lu, ps


factorize.launches = 0


def solve(ds: DeviceSchedule, fact, rhs: torch.Tensor) -> torch.Tensor:
    """Two-pass block backsubstitution on node vectors (B, N, W).

    Replaces solve_kernel / _call_solve (dojo_tpu/pallas_ldu.py:286, :304).
    Bound on the card: the dependency chain of 2×8 levels of W-step
    substitutions; the data (factored blocks + LU + PS) is read once.
    Design: one CTA per lane, the lane's node vectors in shared memory,
    up to 16 node solves or edge products in parallel per step."""
    fb, lu, ps = fact
    if not _plain_or_cuda(rhs):
        return ldu.solve(ds.plan, fact, rhs)
    suffix, B, dev = _cuda_args(ds, blocks=fb, lu=lu, ps=ps, x=rhs)
    out = torch.empty_like(rhs)
    if B:
        _launch("solve", suffix, ds, B, dev,
                fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), rhs.data_ptr(), out.data_ptr())
        solve.launches += 1
    return out


solve.launches = 0


def matvec(ds: DeviceSchedule, blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact block product y[a] = Σ_{slots (a,b)} block·x[b], node vectors.

    Replaces matvec_kernel / _call_matvec (dojo_tpu/pallas_ldu.py:292, :321).
    Bound on the card: reading the (B, S, W, W) blocks once (bytes).
    Design: one CTA per lane, x in shared memory, one thread per output
    row summing its node's slots in slot order."""
    if not _plain_or_cuda(x):
        return ldu.matvec(ds.plan, blocks, x)
    suffix, B, dev = _cuda_args(ds, blocks=blocks, x=x)
    out = torch.empty_like(x)
    if B:
        _launch("matvec", suffix, ds, B, dev, blocks.data_ptr(), x.data_ptr(), out.data_ptr())
        matvec.launches += 1
    return out


matvec.launches = 0


def solve_refine(ds: DeviceSchedule, blocks, fact, rhs: torch.Tensor, n_ref: int):
    """Solve, then ``n_ref`` × (matvec, solve) iterative-refinement sweeps —
    the order of dojo_tpu/pallas_ldu.py solve_b."""
    x = solve(ds, fact, rhs)
    for _ in range(n_ref):
        x = x + solve(ds, fact, rhs - matvec(ds, blocks, x))
    return x


def reset_launches():
    for fn in (factorize, solve, matvec):
        fn.launches = 0
