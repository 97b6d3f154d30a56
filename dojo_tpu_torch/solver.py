"""Mehrotra predictor-corrector interior-point solver, batched over lanes.

Counterpart of dojo_tpu/solver.py.  Every function takes a leading lane
dimension B; ``lax.while_loop`` becomes a Python loop that runs until every
lane is done, updating only the lanes that are still active (the semantics
of a vmapped while_loop, lane by lane).  Each Newton iteration assembles the
KKT blocks by local forward-mode AD (blocks.py), factorizes them once with
the graph-sparse block LDU and solves twice (affine and corrected), each
solve followed by ``refine`` iterative-refinement sweeps in float32.  On a
CUDA tensor the LDU runs the three kernels of csrc/ldu.cu, on a CPU tensor
their plain PyTorch versions (ldu_cuda.py dispatches on the device).

Load-bearing details kept from the reference: true-f32 matmuls (TF32 off),
the τ schedule, centering exponent 3, the btol/undercut μ floor, the
no-progress undercut escalation, the ω clamp, the float32 stall exit and
the dense pivoted-LU rescue of lanes where the float32 LDU stalls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import contacts as ct
from . import ldu_cuda as L
from .blocks import Assembler, local_jacobian
from .core import (
    REG,
    Params,
    SolverOptions,
    Topology,
    cone_index_sets,
    joint_limit_activity,
    resolve_device,
    tensor_map,
)
from .graph import build_schedule
from .residual import Residual, StepContext


@dataclasses.dataclass
class SolveResult:
    w: torch.Tensor  # (B, dim) solution [v25 ω25 | joint impulses | contact impulses]
    success: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int
    rvio: torch.Tensor
    bvio: torch.Tensor
    mu: torch.Tensor  # final complementarity target
    rescued: torch.Tensor  # lane finished by the dense rescue pass


def _ort_alpha(lam, dl, act, tau):
    """Positive-orthant max step per lane."""
    bad = (dl < 0) & (act > 0)
    cand = -tau * lam / torch.where(bad, dl, -torch.ones_like(dl))
    return torch.where(bad, cand, torch.full_like(cand, 1e20)).amin(-1).clamp_max(1e20)


def _soc_alpha(lam, dl, tau):
    """Second-order-cone max step (CVXOPT §8.2), per cone (..., n, 3)."""
    eps = 1e-14
    l0, l1 = lam[..., 0], lam[..., 1:]
    ll = torch.clamp_min(l0 * l0 - (l1 * l1).sum(-1), 1e-25) + eps
    ld = l0 * dl[..., 0] - (l1 * dl[..., 1:]).sum(-1) + eps
    sq = torch.sqrt(ll)
    rs = ld / ll
    rv = dl[..., 1:] / sq[..., None] - ((ld / sq + dl[..., 0]) / (l0 / sq + 1.0))[
        ..., None
    ] * l1 / ll[..., None]
    gap = torch.linalg.vector_norm(rv, dim=-1) - rs
    return torch.where(gap > 0.0, torch.clamp_max(tau / gap, 1.0), torch.ones_like(gap))


def _ort_init(g, s, eps=1e-20):
    """Strictly-feasible orthant shift."""
    ds = torch.clamp_min(-1.5 * s.min(), 0.0)
    dg = torch.clamp_min(-1.5 * g.min(), 0.0)
    sh, gh = s + ds, g + dg
    dot = sh @ gh
    return gh + 0.5 * dot / (sh.sum() + eps), sh + 0.5 * dot / (gh.sum() + eps)


def _soc_init(g, s, eps=1e-20):
    """Strictly-feasible second-order-cone shift."""
    e = torch.zeros_like(g)
    e[0] = 1.0
    nrm = lambda v: torch.linalg.vector_norm(v[1:])
    ds = torch.clamp_min(-1.5 * (s[0] - nrm(s)), 0.0)
    dg = torch.clamp_min(-1.5 * (g[0] - nrm(g)), 0.0)
    sh, gh = s + ds * e, g + dg * e
    dot = sh @ gh
    return gh + 0.5 * dot / (sh[0] + nrm(sh) + eps) * e, sh + 0.5 * dot / (gh[0] + nrm(gh) + eps) * e


def _lanes(obj, idx):
    """Select lanes idx of every tensor field of a dataclass."""
    return tensor_map(lambda a: a[idx], obj)


def _where(mask, new, old):
    """Per-lane select for (B, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def make_solver(topo: Topology, device=None, linsolve: str = "auto"):
    """Build (init_w, solve, violations) for a topology on a device.

    linsolve "auto": the Newton systems go through the graph-sparse block
    LDU when the mechanism graph has an elimination schedule (it is
    loop-free), else through the dense LU; "dense" forces the dense pivoted
    LU (the rescue's path) for every lane, with no rescue pass.
    """
    if linsolve not in ("auto", "dense"):
        raise ValueError(f"linsolve must be 'auto' or 'dense', got {linsolve!r}")
    device = resolve_device(device)
    # true float32: TF32 passes would break the Newton pipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_fn = Residual(topo, device)
    cones = cone_index_sets(topo)
    sched = build_schedule(topo) if linsolve == "auto" else None
    if sched is not None:
        assemble = Assembler(topo, sched, device)
        dsched = L.DeviceSchedule(sched, device)
    D = topo.dim
    nb, nj, nc, ML = topo.nb, topo.nj, topo.nc, topo.maxlim
    SW, JW, CW = topo.sw, topo.jw, topo.cw
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    ort_s, ort_g = idx(cones["ort_s"]), idx(cones["ort_g"])
    soc_s, soc_g = idx(cones["soc_s"]), idx(cones["soc_g"])
    n_ort, n_soc = len(cones["ort_s"]), len(cones["soc_s"])
    n_joint_ort = cones["n_joint_ort"]

    # rvio row weights: body rows + contact constraint rows; joint e1 rows
    # weighted by their λ activity
    rv_static = np.zeros(D)
    rv_static[: 6 * nb] = 1.0
    for c in range(nc):
        o = topo.contact_off + c * CW
        rv_static[o + CW // 2 : o + CW] = 1.0
    lam_rows = []
    for j in range(nj):
        for sub in range(2):
            o = topo.joint_off + j * JW + sub * SW + 4 * ML
            lam_rows.extend([o, o + 1, o + 2])
    lam_rows = idx(lam_rows)
    rv_static = torch.as_tensor(rv_static, device=device)
    w_slots = idx(np.arange(nb)[:, None] * 6 + np.arange(3, 6)[None, :])

    def rvio_weights(params: Params):
        wgt = rv_static.to(params.mass.dtype).clone()
        if nj:
            lam_act = torch.stack([params.tra_lam_mask, params.rot_lam_mask], dim=1)
            wgt[lam_rows] = lam_act.reshape(-1)
        return wgt

    def ort_activity(params: Params):
        acts = []
        if n_joint_ort:
            acts.append(joint_limit_activity(topo, params))
        if n_ort - n_joint_ort:
            acts.append(params.mass.new_ones(n_ort - n_joint_ort))
        return torch.cat(acts) if acts else params.mass.new_zeros(0)

    def violations(w, ctx, params, rvw, oact):
        """(rvio, bvio) per lane at w (μ-independent)."""
        r0 = res_fn(w, ctx, params, 0.0)
        rvio = (r0.abs() * rvw).amax(-1).clamp_min(0.0)
        bvio = torch.zeros_like(rvio)
        if n_ort:
            bvio = (torch.abs(w[:, ort_s] * w[:, ort_g]) * oact).amax(-1).clamp_min(0.0)
        if n_soc:
            cp = ct.cone_product(w[:, soc_g], w[:, soc_s])
            bvio = torch.maximum(bvio, cp.abs().amax((-2, -1)))
        return rvio, bvio

    def cone_line_search(w, dw, tort, tsoc, oact):
        alpha = w.new_ones(w.shape[0])
        tort = torch.as_tensor(tort, dtype=w.dtype, device=w.device).reshape(-1, 1)
        tsoc = torch.as_tensor(tsoc, dtype=w.dtype, device=w.device).reshape(-1, 1)
        if n_ort:
            alpha = torch.minimum(alpha, _ort_alpha(w[:, ort_s], dw[:, ort_s], oact, tort))
            alpha = torch.minimum(alpha, _ort_alpha(w[:, ort_g], dw[:, ort_g], oact, tort))
        if n_soc:
            a_s = _soc_alpha(w[:, soc_s], dw[:, soc_s], tsoc).amin(-1)
            a_g = _soc_alpha(w[:, soc_g], dw[:, soc_g], tsoc).amin(-1)
            alpha = torch.minimum(alpha, torch.minimum(a_s, a_g))
        return torch.clamp_max(alpha, 1.0)

    def centering(w, dw, aaff, oact):
        """Aggregate duality measure ν, νaff per lane."""
        nu = nuaff = w.new_zeros(w.shape[0])
        degree = 0.0
        a = aaff[:, None]
        if n_ort:
            s, g, ds, dg = w[:, ort_s], w[:, ort_g], dw[:, ort_s], dw[:, ort_g]
            nu = nu + (oact * s * g).sum(-1)
            nuaff = nuaff + (oact * (s + a * ds) * (g + a * dg)).sum(-1)
            degree = degree + oact.sum()
        if n_soc:
            s, g, ds, dg = w[:, soc_s], w[:, soc_g], dw[:, soc_s], dw[:, soc_g]
            a3 = a[:, :, None]
            nu = nu + (s * g).sum((-2, -1))
            nuaff = nuaff + ((s + a3 * ds) * (g + a3 * dg)).sum((-2, -1))
            degree = degree + n_soc
        degree = torch.clamp_min(torch.as_tensor(degree, dtype=w.dtype, device=w.device), 1.0)
        return nu / degree, nuaff / degree

    def correction(dw, mu, oact):
        """Second-order correction added to the (−r) right-hand side."""
        corr = torch.zeros_like(dw)
        if n_ort:
            corr[:, ort_s] = oact * (-dw[:, ort_s] * dw[:, ort_g] + mu[:, None])
        if n_soc:
            cp = ct.cone_product(dw[:, soc_s], dw[:, soc_g])
            mu_e = torch.nn.functional.pad(mu[:, None, None], (0, 2))
            corr[:, soc_s] = -cp + mu_e
        return corr

    def clamp_omega(w, wmax):
        """ω-norm clamp (factor ωmax/ω² as in the reference)."""
        if nb == 0:
            return w
        om = w[:, w_slots]
        wd = torch.sum(om * om, dim=-1, keepdim=True)
        factor = torch.where(wd > wmax, wmax / wd, torch.ones_like(wd))
        w = w.clone()
        w[:, w_slots] = om * factor
        return w

    def backtrack(w_acc, dw, alpha, rvio, bvio, ctx, params, rvw, oact, opts, wmax):
        """Scale-halving line search, per lane."""

        def make_cand(scale):
            return clamp_omega(w_acc + (alpha / 2.0**scale)[:, None] * dw, wmax)

        def accept(rv, bv):  # NaN reads as worse
            return (rv <= rvio) | (bv <= bvio)

        wc = make_cand(torch.zeros_like(alpha))
        rv, bv = violations(wc, ctx, params, rvw, oact)
        scale = torch.ones_like(alpha)
        ok = accept(rv, bv)
        while True:
            act = (~ok) & (scale < opts.max_ls)
            if not bool(act.any()):
                break
            wn = make_cand(scale)
            rvn, bvn = violations(wn, ctx, params, rvw, oact)
            ok = torch.where(act, accept(rvn, bvn), ok)
            wc, rv, bv = _where(act, wn, wc), _where(act, rvn, rv), _where(act, bvn, bv)
            scale = torch.where(act, scale + 1, scale)
        # non-finite final candidate (diverged solve): keep the incumbent
        keep = torch.isfinite(rv) & torch.isfinite(bv)
        return _where(keep, wc, w_acc), _where(keep, rv, rvio), _where(keep, bv, bvio)

    def neutral_contact_blocks(dtype):
        """(nc, CW) strictly-feasible neutral contact blocks [s0, g0]."""
        neutral = ct.neutral_vector(dtype, device)
        g_o, s_o = _ort_init(neutral[:1], neutral[:1])
        g_s, s_s = _soc_init(neutral[1:4], neutral[1:4])
        return torch.cat([s_o, s_s, g_o, g_s]).expand(nc, CW)

    def joint_neutral(dtype):
        sub = torch.cat([torch.ones(4 * ML, dtype=dtype), torch.zeros(3, dtype=dtype)])
        return sub.repeat(2 * nj).to(device)

    def init_w(state_v, state_w, params: Params, w_prev=None, warm_floor=1e-2,
               contact_reset=None):
        """Initial point per lane.  w_prev=None: velocities from the state,
        cone variables at the strictly-feasible neutral point.  With w_prev
        (the previous step's solution) multipliers and cone pairs carry
        over, floored into the cone interior; contacts flagged in
        contact_reset (B, nc) and, on such a transient step, the joint
        impulses restart from the neutral point."""
        dtype = state_v.dtype
        B = state_v.shape[0]
        vel = torch.cat([state_v, state_w], dim=-1).reshape(B, -1)
        if w_prev is not None:
            w = w_prev.to(dtype).clone()
            w[:, : 6 * nb] = vel
            fl = warm_floor
            if n_ort:
                w[:, ort_s] = torch.clamp_min(w[:, ort_s], fl)
                w[:, ort_g] = torch.clamp_min(w[:, ort_g], fl)
            if n_soc:
                for ix in (soc_s, soc_g):
                    blk = w[:, ix]
                    t0 = torch.maximum(blk[..., 0], torch.linalg.vector_norm(blk[..., 1:], dim=-1) + fl)
                    w[:, ix[:, 0]] = t0
            if contact_reset is not None and nc:
                mask = contact_reset.to(dtype)[..., None]
                cur = w[:, topo.contact_off :].reshape(B, nc, CW)
                cur = mask * neutral_contact_blocks(dtype) + (1.0 - mask) * cur
                w[:, topo.contact_off :] = cur.reshape(B, -1)
                if nj:
                    transient = contact_reset.to(dtype).amax(-1, keepdim=True)
                    jsl = slice(topo.joint_off, topo.contact_off)
                    w[:, jsl] = transient * joint_neutral(dtype) + (1.0 - transient) * w[:, jsl]
            return w
        parts = [vel]
        if nj:
            parts.append(joint_neutral(dtype).expand(B, -1))
        if nc:
            parts.append(neutral_contact_blocks(dtype).reshape(1, -1).expand(B, -1))
        return torch.cat(parts, dim=-1)

    def make_iteration(ctx: StepContext, params: Params, opts: SolverOptions,
                       force_dense: bool = False):
        """One Mehrotra iteration as a map of the per-lane state tuple
        (w, rvio, bvio, mu, undercut, no-progress count, iterations, done)."""
        rvw = rvio_weights(params)
        oact = ort_activity(params)
        h = params.timestep
        wmax = 3.9 / h**2
        use_ldu = sched is not None and not force_dense

        def body(st):
            w, rvio, bvio, mu_asm, ucut, noprog, it, _ = st
            wdtype = w.dtype
            r = res_fn(w, ctx, params, mu_asm)
            if use_ldu:
                blocks0 = assemble(w, ctx, params, mu_asm)
                fdtype = torch.float64 if (wdtype == torch.float32 and opts.ldu_f64) else wdtype
                fblocks = blocks0.to(fdtype).contiguous()
                n_ref = opts.refine if fdtype == torch.float32 else 0
                fact = L.factorize(dsched, fblocks)

                def lin_solve(rhs):
                    b = L.flat_to_nodes(dsched.plan, rhs.to(fdtype)).contiguous()
                    x = L.solve_refine(dsched, fblocks, fact, b, n_ref)
                    return L.nodes_to_flat(dsched.plan, x, D).to(wdtype)

            else:
                J = local_jacobian(lambda u: res_fn(u, ctx, params, mu_asm), w)
                J = J + REG * torch.eye(D, dtype=wdtype, device=w.device)
                LU, piv = torch.linalg.lu_factor(J)

                def lin_solve(rhs):
                    return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]

            daff = lin_solve(-r)
            aaff = cone_line_search(w, daff, 0.95, 0.95, oact)
            nu, nuaff = centering(w, daff, aaff, oact)
            sigma = torch.clamp(nuaff / (nu + 1e-20), 0.0, 1.0) ** 3
            mu_t = torch.maximum(sigma * nu, opts.btol / ucut)
            d = lin_solve(-r + correction(daff, mu_t, oact))
            tau = torch.clamp_min(1.0 - torch.maximum(rvio, bvio) ** 2, 0.95)
            alpha = cone_line_search(w, d, tau, torch.clamp_max(tau, 0.95), oact)
            w2, rv2, bv2 = backtrack(w, d, alpha, rvio, bvio, ctx, params, rvw, oact, opts, wmax)
            progress = (~(rv2 < opts.rtol) & (rv2 < 0.8 * rvio)) | (
                ~(bv2 < opts.btol) & (bv2 < 0.8 * bvio)
            )
            noprog2 = torch.where(progress, torch.clamp_min(noprog - 1, 0), noprog + 1)
            ucut2 = torch.where(noprog2 >= opts.no_progress_max, ucut * opts.no_progress_undercut, ucut)
            done = (rv2 < opts.rtol) & (bv2 < opts.btol)
            if use_ldu and wdtype == torch.float32 and not opts.ldu_f64:
                # float32 stall exit: once the no-progress undercut has
                # escalated twice the factorization has broken down — stop
                # and leave the lane (reported failed) to the dense rescue
                stalled = ucut2 > opts.undercut * opts.no_progress_undercut * 1.5
                done = done | stalled
            return (w2, rv2, bv2, mu_t, ucut2, noprog2, it + 1, done)

        return body

    def start(opts, done0, w0, rv0, bv0):
        """The per-lane state tuple before the first iteration."""
        B = w0.shape[0]
        zeros = torch.zeros(B, dtype=torch.int32, device=w0.device)
        return (w0, rv0, bv0, w0.new_zeros(B), w0.new_full((B,), opts.undercut), zeros,
                zeros, done0)

    def run(body, opts, done0, w0, rv0, bv0):
        st = start(opts, done0, w0, rv0, bv0)
        while True:
            active = (~st[7]) & (st[6] < opts.max_iter)
            if not bool(active.any()):
                break
            st = tuple(_where(active, n, o) for n, o in zip(body(st), st))
        w, rvio, bvio, mu, _, _, it, _ = st
        # success from the violation test, not the loop flag: the float32
        # stall exit sets done with failing violations
        success = (rvio < opts.rtol) & (bvio < opts.btol)
        return SolveResult(w, success, it, rvio, bvio, mu, torch.zeros_like(success))

    def solve(w0, ctx: StepContext, params: Params, opts: SolverOptions) -> SolveResult:
        rvw = rvio_weights(params)
        oact = ort_activity(params)
        rv0, bv0 = violations(w0, ctx, params, rvw, oact)
        done0 = (rv0 < opts.rtol) & (bv0 < opts.btol)
        res = run(make_iteration(ctx, params, opts), opts, done0, w0, rv0, bv0)
        if sched is None or w0.dtype != torch.float32 or opts.ldu_f64 or not opts.rescue:
            return res
        failed = torch.nonzero(~res.success)[:, 0]
        if failed.numel() == 0:
            return res
        # rescue: re-solve the failed lanes with the dense pivoted LU from the
        # cone-NEUTRAL init (keeping w0's velocities) — a stalled or warm
        # iterate near the cone boundary poisons the dense re-solve
        ctx_f = _lanes(ctx, failed)
        vel = w0[failed, : 6 * nb].reshape(-1, nb, 6)
        w_cold = init_w(vel[..., :3], vel[..., 3:], params)
        rv_c, bv_c = violations(w_cold, ctx_f, params, rvw, oact)
        done_c = (rv_c < opts.rtol) & (bv_c < opts.btol)
        res2 = run(make_iteration(ctx_f, params, opts, force_dense=True), opts, done_c,
                   w_cold, rv_c, bv_c)
        out = tensor_map(torch.clone, res)
        out.w[failed] = res2.w
        out.success[failed] = res2.success
        out.iterations[failed] += res2.iterations
        out.rvio[failed], out.bvio[failed], out.mu[failed] = res2.rvio, res2.bvio, res2.mu
        out.rescued[failed] = res2.success
        return out

    def solve_traced(w0, ctx: StepContext, params: Params, opts: SolverOptions):
        """solve() with a per-iteration record: a fixed max_iter loop of the
        same iteration, with finished lanes frozen and no host check between
        iterations (the line search still checks its rounds).  Returns
        (SolveResult, trace): trace holds (max_iter, B) tensors rvio, bvio,
        mu, undercut and valid (the lane iterated).  No dense rescue runs
        (``rescued`` is all False); lanes that solve() does not rescue get
        its result."""
        rvw = rvio_weights(params)
        oact = ort_activity(params)
        rv0, bv0 = violations(w0, ctx, params, rvw, oact)
        st = start(opts, (rv0 < opts.rtol) & (bv0 < opts.btol), w0, rv0, bv0)
        body = make_iteration(ctx, params, opts)
        rec = {k: [] for k in ("rvio", "bvio", "mu", "undercut", "valid")}
        for _ in range(opts.max_iter):
            done_in = st[7]
            st = tuple(_where(done_in, o, n) for n, o in zip(body(st), st))
            for k, v in zip(("rvio", "bvio", "mu", "undercut"), st[1:5]):
                rec[k].append(v)
            rec["valid"].append(~done_in)
        w, rvio, bvio, mu, _, _, it, _ = st
        success = (rvio < opts.rtol) & (bvio < opts.btol)
        res = SolveResult(w, success, it, rvio, bvio, mu, torch.zeros_like(success))
        return res, {k: torch.stack(v) for k, v in rec.items()}

    solve.traced = solve_traced
    return init_w, solve, violations
