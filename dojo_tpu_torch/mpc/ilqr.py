"""Runtime-gains iLQR / MPC over minimal coordinates, batched over
scenario lanes (counterpart of dojo_tpu/mpc/ilqr.py, the rt path).

Dynamics come from the IFT linearization of the contact step
(gradients.make_rollout_linearize_minimal).  Where the reference vmaps and
scans, the port runs lanes in a leading axis and loops in Python:

  - scenario lanes B: every function takes (B, ...) states and controls;
  - the α candidates of the line search are folded into the lane axis,
    B·nα lanes per forward solve (lane b·nα + a holds scenario b, α_a);
  - the rollouts and the Riccati pass are Python loops over the knots, the
    Riccati pass with batched Cholesky factorizations;
  - linearize takes all B·H knots in one batch (or in knot chunks).

Each iteration: linearize along the trajectory (one KKT factorization per
knot, shared across its tangent columns), a backward Riccati pass with the
cost weights, regularization and control clamp as runtime data, then an
α-batched forward rollout; each scenario keeps its best candidate if it
lowers the cost.  Parameters and gains are shared by all lanes.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import Params, SolverOptions, Topology
from ..gradients import make_rollout_linearize_minimal


class QuadCost(NamedTuple):
    """Quadratic tracking cost  Σ (y−y*)ᵀQ(y−y*) + uᵀRu  + terminal Qf."""

    Q: torch.Tensor  # (ny,) diagonal or (ny, ny)
    R: torch.Tensor  # (nu,) diagonal or (nu, nu)
    Qf: torch.Tensor
    y_goal: torch.Tensor  # (ny,) or (H+1, ny) for tracking


class ILQRConfig(NamedTuple):
    """What _make_parts reads of dojo_tpu's ILQRConfig; the iteration
    count, regularization schedule and step sizes of make_ilqr come with
    make_ilqr."""

    # >0: linearize the trajectory in chunks of this many knots of every
    # scenario instead of all H knots at once; bounds the memory held by
    # the per-knot KKT blocks and tangent columns, with the same results
    linearize_chunk: int = 0


def _mat(d, n):
    d = torch.as_tensor(d)
    return torch.diag(d.expand(n)) if d.ndim <= 1 else d


class Trace:
    """Wall time and solver counts per part of a call, for a caller that
    measures.  Each part runs behind torch.cuda.synchronize() on a card;
    ``ms[part]`` sums its wall milliseconds, ``counts[part]`` its counts
    (step_w's solves, lanes, Newton iterations and rescued lanes, plus the
    picks of the line search) as tensors or ints.  ``linearized_at``
    holds the (ys, us, ws, mus) of the last linearization."""

    def __init__(self):
        self.ms: dict = {}
        self.counts: dict = {}
        self.linearized_at = None

    @contextlib.contextmanager
    def part(self, name: str, device: torch.device):
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        yield self.counts.setdefault(name, {})
        sync()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3


def _part(trace, name, like):
    """trace.part(name) for a call that is traced, else a no-op yielding None."""
    return trace.part(name, like.device) if trace is not None else contextlib.nullcontext()


class _Parts(NamedTuple):
    """Shared iLQR building blocks (closures) of the rt controller."""

    step_w: object
    w_seed: object
    rollout: object
    linearize: object
    stage_cost: object
    term_cost: object
    nu: int
    ny: int


def _make_parts(topo: Topology, cost: QuadCost, horizon: int, config: ILQRConfig,
                opts: SolverOptions, act_idx=None, linsolve: str = "auto",
                device=None) -> _Parts:
    step_w_full, linearize_full, w_seed_full = make_rollout_linearize_minimal(
        topo, opts, linsolve=linsolve, device=device
    )
    ny = topo.minimal_dim
    n_packed = topo.input_dim
    if act_idx is None:
        nu = n_packed
        expand = lambda u: u
        shrink_B = lambda B: B
    else:
        act_idx = np.asarray(act_idx, dtype=np.int64)
        nu = len(act_idx)
        # packed input i reads actuated control src[i]; index nu reads zero
        src = np.full(n_packed, nu, dtype=np.int64)
        src[act_idx] = np.arange(nu)
        src_t = torch.as_tensor(src)
        act_t = torch.as_tensor(act_idx)
        expand = lambda u: torch.nn.functional.pad(u, (0, 1))[..., src_t.to(u.device)]
        shrink_B = lambda B: B[..., act_t.to(B.device)]

    def step_w(params, y, u, w_prev=None, stats=None):
        return step_w_full(params, y, expand(u), w_prev=w_prev, stats=stats)

    Qm, Rm, Qfm = _mat(cost.Q, ny), _mat(cost.R, nu), _mat(cost.Qf, ny)

    def quad(M, d):
        return torch.einsum("...i,ij,...j->...", d, M.to(d), d)

    def stage_cost(y, u, g):
        return quad(Qm, y - g) + quad(Rm, u)

    def term_cost(y, g):
        return quad(Qfm, y - g)

    def rollout(params, y0, us, goals, w_seed, stats=None):
        """Rollout of B scenarios over the H knots of us (B, H, nu), carrying
        the contact-solver solution along the trajectory (each knot
        warm-starts from its predecessor); returns ys (B, H+1, ny), the
        cost (B,) and the per-knot (w, μ, success) so that linearize reuses
        the solves."""
        y, w_prev = y0, w_seed
        ys, ws, mus, oks = [y0], [], [], []
        for t in range(us.shape[1]):
            y, w_prev, mu, ok = step_w(params, y, us[:, t], w_prev=w_prev, stats=stats)
            ys.append(y)
            ws.append(w_prev)
            mus.append(mu)
            oks.append(ok)
        ys = torch.stack(ys, 1)
        c = stage_cost(ys[:, :-1], us, goals[..., :-1, :]).sum(-1) + term_cost(
            ys[:, -1], goals[..., -1, :])
        return ys, c, (torch.stack(ws, 1), torch.stack(mus, 1), torch.stack(oks, 1))

    def linearize(params, ys, us, ws, mus):
        """IFT Jacobians (B, H, ny, ny), (B, H, ny, nu) at every knot: one
        Jacobian assembly + factorization per knot, no extra contact solves
        (gradients.make_rollout_linearize_minimal)."""
        B, Hk = us.shape[:2]
        chunk = config.linearize_chunk if 0 < config.linearize_chunk < Hk else Hk
        As, Bs = [], []
        for t0 in range(0, Hk, chunk):
            sl = slice(t0, min(t0 + chunk, Hk))
            flat = lambda a: a[:, sl].reshape(-1, *a.shape[2:])
            A, Bm = linearize_full(params, flat(ys[:, :-1]), expand(flat(us)), flat(ws),
                                   flat(mus))
            n = sl.stop - sl.start
            As.append(A.reshape(B, n, ny, ny))
            Bs.append(shrink_B(Bm).reshape(B, n, ny, nu))
        return torch.cat(As, 1), torch.cat(Bs, 1)

    return _Parts(
        step_w=step_w, w_seed=w_seed_full, rollout=rollout, linearize=linearize,
        stage_cost=stage_cost, term_cost=term_cost, nu=nu, ny=ny,
    )


class _RTCore(NamedTuple):
    """Shared runtime-gains iLQR machinery (make_ilqr_rt)."""

    p: _Parts
    cost_rt: object
    backward_rt: object
    forward_rt: object
    sanitize: object
    ny: int
    nu: int


def _make_rt_core(topo: Topology, horizon: int, opts: SolverOptions, act_idx,
                  linsolve: str, device=None) -> _RTCore:
    ny = topo.minimal_dim
    n_packed = topo.input_dim
    nu = n_packed if act_idx is None else len(np.asarray(act_idx))
    dummy = QuadCost(Q=torch.ones(ny), R=torch.ones(nu), Qf=torch.ones(ny),
                     y_goal=torch.zeros(ny))
    p = _make_parts(topo, dummy, horizon, ILQRConfig(), opts, act_idx, linsolve, device)
    H = horizon

    def cost_rt(ys, us, goals, Qd, Rd, Qfd):
        """Cost per lane of ys (..., H+1, ny), us (..., H, nu).  Qd: (ny,)
        constant or (H+1, ny) per-knot schedule (mpc/trot.py
        trot_weight_schedule)."""
        Qk = Qd.expand(H + 1, ny)
        dy = ys[..., :-1, :] - goals[..., :-1, :]
        cf = ys[..., -1, :] - goals[..., -1, :]
        return ((dy * dy * Qk[:-1]).sum((-2, -1)) + (us * us * Rd).sum((-2, -1))
                + (cf * cf * Qfd).sum(-1))

    def backward_rt(As, Bs, ys, us, goals, Qd, Rd, Qfd, reg):
        """Riccati pass over the knots, batched over lanes: gains ks (B, H,
        nu), Ks (B, H, nu, ny).  A Quu that is not positive definite gives
        NaN gains, as the reference's Cholesky does."""
        Qk = Qd.expand(H + 1, ny)
        lys = 2.0 * (ys[:, :-1] - goals[..., :-1, :]) * Qk[:-1]
        lus = 2.0 * us * Rd
        V = torch.diag_embed(2.0 * Qfd).expand(ys.shape[0], ny, ny)
        v = 2.0 * Qfd * (ys[:, -1] - goals[..., -1, :])
        eye_u = torch.eye(nu, dtype=ys.dtype, device=ys.device)
        R2 = torch.diag(2.0 * Rd)
        mv = lambda M, x: (M @ x[..., None])[..., 0]
        ks, Ks = [None] * H, [None] * H
        for t in reversed(range(H)):
            A, B = As[:, t], Bs[:, t]
            At, Bt = A.mT, B.mT
            Qx = lys[:, t] + mv(At, v)
            Qu = lus[:, t] + mv(Bt, v)
            Qxx = torch.diag_embed(2.0 * Qk[t]) + At @ V @ A
            Quu = R2 + Bt @ V @ B + reg * eye_u
            Qux = Bt @ V @ A
            L, info = torch.linalg.cholesky_ex(Quu + 1e-8 * eye_u)
            L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
            k = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
            Km = -torch.cholesky_solve(Qux, L)
            KmT = Km.mT
            V = Qxx + KmT @ Quu @ Km + KmT @ Qux + Qux.mT @ Km
            v = Qx + mv(KmT @ Quu, k) + mv(KmT, Qu) + mv(Qux.mT, k)
            ks[t], Ks[t] = k, Km
        return torch.stack(ks, 1), torch.stack(Ks, 1)

    def forward_rt(params, ys, us, ks, Ks, alpha, wseed, du_max, stats=None):
        """Closed-loop rollout of the lanes, each with its own step size
        alpha (lanes,): u = u_ref + clip(α k + K (y − y_ref), ±du_max)."""
        y, w_prev = ys[:, 0], wseed
        a = alpha[:, None]
        ys2, us2, ws, mus, oks = [ys[:, 0]], [], [], [], []
        for t in range(us.shape[1]):
            du = a * ks[:, t] + (Ks[:, t] @ (y - ys[:, t])[..., None])[..., 0]
            du = torch.clamp(du, -du_max, du_max)
            u = us[:, t] + du
            y, w_prev, mu, ok = p.step_w(params, y, u, w_prev=w_prev, stats=stats)
            ys2.append(y)
            us2.append(u)
            ws.append(w_prev)
            mus.append(mu)
            oks.append(ok)
        st = lambda xs: torch.stack(xs, 1)
        return st(ys2), st(us2), st(ws), st(mus), st(oks)

    def sanitize(As, Bs):
        """Degrade non-finite knots to (A=I, B=0): the float32 graph-LDU
        linearization has no rescue pass, and one hard-impact NaN knot would
        otherwise poison the whole Riccati recursion."""
        fin = torch.isfinite(As).all(-1).all(-1) & torch.isfinite(Bs).all(-1).all(-1)
        eye_y = torch.eye(ny, dtype=As.dtype, device=As.device)
        As = torch.where(fin[..., None, None], As, eye_y)
        Bs = torch.where(fin[..., None, None], Bs, torch.zeros_like(Bs))
        return As, Bs

    return _RTCore(p=p, cost_rt=cost_rt, backward_rt=backward_rt, forward_rt=forward_rt,
                   sanitize=sanitize, ny=ny, nu=nu)


def make_ilqr_rt(topo: Topology, horizon: int,
                 opts: SolverOptions = SolverOptions(rtol=1e-4, btol=1e-3, max_iter=16),
                 act_idx=None, alphas=(1.0, 0.5, 0.25, 0.1), iterations: int = 1,
                 linsolve: str = "auto", device=None):
    """iLQR with the tuning surface as runtime data, batched over B
    scenario lanes; ``device=None`` means CUDA.

        ilqr_rt(params, y0, us_init, goals, Qd, Rd, Qfd, reg, du_max, trace=None)
            → (us (B, H, nu), ys (B, H+1, ny), cost (B,), okf (B,))

    y0 (B, ny), us_init (B, H, nu); goals (H+1, ny); Qd/Qfd (ny,) — or Qd
    (H+1, ny) for per-knot schedules — and Rd (nu,) diagonal cost weights,
    ``reg`` the Quu Levenberg shift, ``du_max`` an elementwise clamp on the
    control update.  okf is the share of successful contact solves of the
    trajectory kept.  ``trace`` (a Trace) collects wall time and counts
    per part: rollout, linearize, backward, forward; among them the
    rollout's cost and the cost after the last iteration (``cost``), the
    knots that sanitize replaced, and per α how often it was the best.
    """
    core = _make_rt_core(topo, horizon, opts, act_idx, linsolve, device)
    p = core.p
    cost_rt, backward_rt, forward_rt = core.cost_rt, core.backward_rt, core.forward_rt
    alphas_c = tuple(float(a) for a in alphas)
    na = len(alphas_c)

    def ilqr_rt(params: Params, y0, us_init, goals, Qd, Rd, Qfd, reg, du_max, trace=None):
        B = y0.shape[0]
        lanes = torch.arange(B, device=y0.device)
        with _part(trace, "rollout", y0) as stats:
            wseed = p.w_seed(params, y0)
            ys, _, (ws, mus, ok0) = p.rollout(params, y0, us_init, goals, wseed, stats)
            c = cost_rt(ys, us_init, goals, Qd, Rd, Qfd)
            if stats is not None:
                stats["cost"] = c
        us = us_init
        okf = ok0.to(y0.dtype).mean(-1)
        alpha = torch.as_tensor(alphas_c, dtype=y0.dtype, device=y0.device).repeat(B)
        rep = lambda a: a.repeat_interleave(na, 0)
        per_alpha = lambda a: a.reshape(B, na, *a.shape[1:])
        for _ in range(iterations):
            with _part(trace, "linearize", y0) as counts:
                As, Bs = p.linearize(params, ys, us, ws, mus)
                if counts is not None:
                    trace.linearized_at = (ys, us, ws, mus)
                    fin = torch.isfinite(As).flatten(2).all(-1) & torch.isfinite(Bs).flatten(2).all(-1)
                    counts["knots"] = counts.get("knots", 0) + fin.numel()
                    counts["sanitized"] = counts.get("sanitized", 0) + (~fin).sum()
                As, Bs = core.sanitize(As, Bs)
            with _part(trace, "backward", y0):
                ks, Ks = backward_rt(As, Bs, ys, us, goals, Qd, Rd, Qfd, reg)
                ks = torch.where(torch.isfinite(ks), ks, torch.zeros_like(ks))
                Ks = torch.where(torch.isfinite(Ks), Ks, torch.zeros_like(Ks))
            with _part(trace, "forward", y0) as stats:
                cand = forward_rt(params, rep(ys), rep(us), rep(ks), rep(Ks), alpha, rep(wseed),
                                  du_max, stats)
                ys_c, us_c, ws_c, mus_c, oks_c = (per_alpha(a) for a in cand)
                cs = cost_rt(ys_c, us_c, goals, Qd, Rd, Qfd)  # (B, nα)
                cs = torch.where(torch.isnan(cs), torch.full_like(cs, float("inf")), cs)
                best = torch.argmin(cs, dim=1)
                improved = cs[lanes, best] < c

                def pick(new, old):
                    nb = new[lanes, best]
                    return torch.where(improved.reshape(-1, *[1] * (nb.ndim - 1)), nb, old)

                ys, us, c = pick(ys_c, ys), pick(us_c, us), pick(cs, c)
                ws, mus = pick(ws_c, ws), pick(mus_c, mus)
                okf = pick(oks_c.to(y0.dtype).mean(-1), okf)
                if stats is not None:
                    stats["best_alpha"] = stats.get("best_alpha", 0) + torch.bincount(
                        best, minlength=na)
                    stats["improved"] = stats.get("improved", 0) + improved.sum()
                    stats["cost"] = c
        return us, ys, c, okf

    return ilqr_rt


def make_mpc_rt(topo: Topology, horizon: int,
                opts: SolverOptions = SolverOptions(rtol=1e-4, btol=1e-3, max_iter=16),
                act_idx=None, alphas=(1.0, 0.5, 0.25, 0.1), iterations: int = 1,
                linsolve: str = "auto", device=None):
    """Receding-horizon wrapper over make_ilqr_rt: warm-shifted re-solve
    per control step, the tuning surface as runtime data.

        mpc(params, y, us_warm, goals, Qd, Rd, Qfd, reg, du_max, trace=None)
            → (u0 (B, nu), us_next (B, H, nu), cost (B,), okf (B,))
    """
    ilqr_rt = make_ilqr_rt(topo, horizon, opts, act_idx, alphas, iterations, linsolve, device)

    def mpc(params, y, us_warm, goals, Qd, Rd, Qfd, reg, du_max, trace=None):
        us, ys, c, okf = ilqr_rt(params, y, us_warm, goals, Qd, Rd, Qfd, reg, du_max, trace)
        us_next = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
        return us[:, 0], us_next, c, okf

    return mpc
