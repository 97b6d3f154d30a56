"""Batched block-sparse LDU factorization/solve on a static schedule.

Counterpart of dojo_tpu/ldu.py, batch-major: blocks are (..., S, W, W) and
node vectors (..., N, W) for any leading lane dimensions.  These are the
plain PyTorch versions of the three CUDA kernels in csrc/ldu.cu
(factorize, solve, matvec; see ldu_cuda.py), and the path every CPU tensor
takes.

Numerics (shared with the kernels): per-node scaled-partial-pivot LU with
the pivot searched over the level's real width only, a signed pivot floor
(1e-12 f32, 1e-30 f64), multipliers in the strict lower triangle, and Schur
updates through LU *solves*, never explicit inverses — the float32 fix for
interior-point endgames (see dojo_tpu/ldu.py blu_factor).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graph import Schedule


def pivot_floor(dtype) -> float:
    return 1e-12 if dtype == torch.float32 else 1e-30


def schur_fma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c − a·b rounded once, as the fused multiply-add that XLA (dojo_tpu)
    and nvcc (the kernels) make of it.  In float32 the product is exact in
    float64 and the difference is rounded to float32 (a second rounding
    differs from the fused one only where the float64 difference lands on
    a float32 tie); in float64, which has no wider type here, the product
    is rounded first.  Rounding the product apart is not a detail in
    float32: at nearly singular nodes it cancels a pivot to exactly 0 (and
    the floor) where the fused form leaves rounding noise."""
    if c.dtype == torch.float32:
        return (c.double() - a.double() * b.double()).float()
    return c - a * b


def blu_factor(D: torch.Tensor, n: int):
    """Batched in-block pivoted LU with scaled partial pivoting.

    D: (..., W, W), invertible leading n×n block, identity on pad dims.
    Returns (LU, PS): LU packs unit-lower L (strict lower triangle) and U;
    PS = P·diag(rowscale), so that PS·D = L·U.

    Rows k and p swap arithmetically, as in dojo_tpu's blu_factor: row k
    becomes Tk + (Tp − Tk) and row p becomes Tp + (Tk − Tp), in every
    column.  In float32 these round away from Tp and Tk, and a pivot that
    cancels to rounding noise keeps that noise instead of landing on exact
    0 (and the floor); PS rows have one nonzero each, so there the swap is
    exact.  The Schur update is fused (``schur_fma``).
    """
    W = D.shape[-1]
    rmax = D.abs().amax(dim=-1, keepdim=True)
    rscale = torch.where(rmax > 0, 1.0 / rmax, torch.ones_like(rmax))
    M = D * rscale
    PS = torch.eye(W, dtype=D.dtype, device=D.device) * rscale
    idx = torch.arange(W, device=D.device)
    tiny = pivot_floor(D.dtype)
    for k in range(n):
        mag = torch.where((idx >= k) & (idx < n), M[..., :, k].abs(),
                          torch.full_like(M[..., :, k], -float("inf")))
        p = mag.argmax(dim=-1)  # first maximum
        rows_p = p[..., None, None].expand(*p.shape, 1, W)
        for T in (M, PS):
            Tp, Tk = T.gather(-2, rows_p), T[..., k : k + 1, :].clone()
            T.scatter_(-2, rows_p, Tp + (Tk - Tp))
            T[..., k : k + 1, :] = Tk + (Tp - Tk)
        a = M[..., k, k]
        a = torch.where(a.abs() > tiny, a,
                        torch.where(a < 0, torch.full_like(a, -tiny), torch.full_like(a, tiny)))
        M[..., k, k] = a
        mult = M[..., k + 1 :, k] / a.unsqueeze(-1)
        M[..., k + 1 :, k + 1 :] = schur_fma(M[..., k + 1 :, k + 1 :], mult.unsqueeze(-1),
                                             M[..., k : k + 1, k + 1 :])
        M[..., k + 1 :, k] = mult
    return M, PS


def blu_solve(LU: torch.Tensor, PS: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve D x = B via the blu_factor factors.  B: (..., W) or (..., W, C).

    Column-oriented substitution over all W rows (pad rows hold the scaled
    identity)."""
    W = LU.shape[-1]
    vec = B.ndim == LU.ndim - 1
    y = PS @ (B.unsqueeze(-1) if vec else B)
    for j in range(W - 1):  # forward: unit-lower
        y[..., j + 1 :, :] -= LU[..., j + 1 :, j : j + 1] * y[..., j : j + 1, :]
    x = torch.empty_like(y)
    for j in range(W - 1, -1, -1):  # backward: upper
        xj = y[..., j : j + 1, :] / LU[..., j : j + 1, j : j + 1]
        x[..., j : j + 1, :] = xj
        if j > 0:
            y[..., :j, :] -= LU[..., :j, j : j + 1] * xj
    return x.squeeze(-1) if vec else x


class LduPlan:
    """A Schedule's index lists as device tensors, for the plain LDU."""

    def __init__(self, sched: Schedule, device):
        dev = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
        self.sched = sched
        self.device = dev
        self.levels = [
            dict(
                nodes=t(lv.nodes), real_w=int(lv.real_w),
                upd_ai=t(lv.upd_ai), upd_inv=t(lv.upd_inv),
                upd_ib=t(lv.upd_ib), upd_tgt=t(lv.upd_tgt),
                fwd_ai=t(lv.fwd_ai), fwd_i=t(lv.fwd_i), fwd_a=t(lv.fwd_a),
                bwd_ia=t(lv.bwd_ia), bwd_i=t(lv.bwd_i), bwd_a=t(lv.bwd_a),
            )
            for lv in sched.levels
        ]
        slot_a = np.zeros(sched.n_slots, dtype=np.int64)
        slot_b = np.zeros(sched.n_slots, dtype=np.int64)
        for (a, b), s in sched.slot.items():
            slot_a[s], slot_b[s] = a, b
        self.slot_a, self.slot_b = t(slot_a), t(slot_b)
        self.vec_idx = t(sched.vec_idx)
        self.vec_valid = torch.as_tensor(sched.vec_valid, device=dev)
        self.rows, self.cols = t(sched.rows), t(sched.cols)
        self.pad_eye = torch.as_tensor(sched.pad_eye, device=dev)


def factorize(plan: LduPlan, blocks: torch.Tensor):
    """Leaves-to-root elimination: (factored blocks, LU (..., N, W, W), PS)."""
    sched = plan.sched
    N, W = sched.n_nodes, sched.width
    slot_dim = blocks.ndim - 3
    fb = blocks.clone()
    LU = blocks.new_zeros(*blocks.shape[:-3], N, W, W)
    PS = torch.zeros_like(LU)
    for lv in plan.levels:
        nodes = lv["nodes"]
        lu_k, ps_k = blu_factor(fb[..., nodes, :, :], lv["real_w"])
        LU[..., nodes, :, :] = lu_k
        PS[..., nodes, :, :] = ps_k
        if lv["upd_tgt"].numel():
            inv = lv["upd_inv"]
            Y = blu_solve(LU[..., inv, :, :], PS[..., inv, :, :], fb[..., lv["upd_ib"], :, :])
            delta = fb[..., lv["upd_ai"], :, :] @ Y
            fb.index_add_(slot_dim, lv["upd_tgt"], -delta)
    return fb, LU, PS


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def _per_fact(k, factors, v):
    """Node vectors v (B·k, N, W) as (B, k, N, W), and the factors (B, ...)
    as (B, 1, ...) so that they broadcast over the k vectors of each lane."""
    if k == 1:
        return factors, v
    return [f.unsqueeze(1) for f in factors], v.reshape(-1, k, *v.shape[1:])


def solve(plan: LduPlan, fact, b: torch.Tensor, rhs_per_fact: int = 1) -> torch.Tensor:
    """Two-pass backsubstitution on node vectors b (..., N, W).

    With ``rhs_per_fact`` = k > 1, b is (B·k, N, W) against a factorization
    of B lanes: vector l is solved with the factors of lane l // k."""
    shape = b.shape
    (fb, LU, PS), b = _per_fact(rhs_per_fact, fact, b)
    node_dim = b.ndim - 2
    b = b.clone()
    for lv in plan.levels:  # forward: leaves → root, b_a -= E_ai D_i⁻¹ b_i
        if lv["fwd_a"].numel():
            i = lv["fwd_i"]
            y = blu_solve(LU[..., i, :, :], PS[..., i, :, :], b[..., i, :])
            b.index_add_(node_dim, lv["fwd_a"], -_mv(fb[..., lv["fwd_ai"], :, :], y))
    x = torch.zeros_like(b)
    for lv in reversed(plan.levels):  # backward: x_i = D_i⁻¹(b_i − Σ E_ia x_a)
        if lv["bwd_i"].numel():
            contrib = _mv(fb[..., lv["bwd_ia"], :, :], x[..., lv["bwd_a"], :])
            b.index_add_(node_dim, lv["bwd_i"], -contrib)
        nodes = lv["nodes"]
        x[..., nodes, :] = blu_solve(LU[..., nodes, :, :], PS[..., nodes, :, :], b[..., nodes, :])
    return x.reshape(shape)


def matvec(plan: LduPlan, blocks: torch.Tensor, x: torch.Tensor,
           rhs_per_fact: int = 1) -> torch.Tensor:
    """Exact block product y[a] = Σ_{slots (a,b)} block·x[b] on node vectors.

    With ``rhs_per_fact`` = k > 1, x is (B·k, N, W) against blocks of B
    lanes: vector l is multiplied by the blocks of lane l // k."""
    shape = x.shape
    (blocks,), x = _per_fact(rhs_per_fact, [blocks], x)
    contrib = _mv(blocks, x[..., plan.slot_b, :])
    y = torch.zeros_like(x)
    return y.index_add_(x.ndim - 2, plan.slot_a, contrib).reshape(shape)


def flat_to_nodes(plan: LduPlan, rhs: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., N, W): pad dims read zero."""
    return F.pad(rhs, (0, 1))[..., plan.vec_idx]


def nodes_to_flat(plan: LduPlan, x: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., N, W) -> (..., D) scatter-add with the validity mask."""
    flat = (x * plan.vec_valid.to(x.dtype)).reshape(*x.shape[:-2], -1)
    out = x.new_zeros(*x.shape[:-2], dim + 1)
    out.index_add_(out.ndim - 1, plan.vec_idx.reshape(-1), flat)
    return out[..., :dim]


def make_ldu(sched: Schedule, device):
    """(extract, factorize, solve, matvec) on flat vectors, batch-major —
    the interface of dojo_tpu.ldu.make_ldu."""
    plan = LduPlan(sched, device)

    def extract(J):
        """Gather node/edge blocks out of a dense (..., dim, dim) Jacobian."""
        Jp = F.pad(J, (0, 1, 0, 1))
        blocks = Jp[..., plan.rows[:, :, None], plan.cols[:, None, :]]
        return blocks + plan.pad_eye.to(J.dtype)

    def solve_flat(fact, rhs):
        return nodes_to_flat(plan, solve(plan, fact, flat_to_nodes(plan, rhs)), rhs.shape[-1])

    def matvec_flat(blocks, v):
        return nodes_to_flat(plan, matvec(plan, blocks, flat_to_nodes(plan, v)), v.shape[-1])

    return extract, (lambda blocks: factorize(plan, blocks)), solve_flat, matvec_flat
