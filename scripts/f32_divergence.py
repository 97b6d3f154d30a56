#!/usr/bin/env python3
"""Where the port's float32 Newton path parts from dojo_tpu's, piece by piece.

    JAX_PLATFORMS=cpu python scripts/f32_divergence.py [--cases cartpole:1,hopper:2]
                                                       [--ulps 8] [--out FILE]

For each case (model:step), the state is the one tests/test_torch_zoo_f32_ref.py
hands to both packages at that step: chip_smoke.zoo_state, then dojo_tpu's own
float32 steps (jitted, bench_zoo's options) up to it.  From there dojo_tpu's
Newton iterates are made by the body that its solve.traced scans
(solve.make_iteration, jitted, a finished iterate frozen), and each iterate
is fed to the port's pieces one at a time, in this order:
  1. residual       dojo_tpu_torch/residual.py Residual at (w, mu), and the
                    violations (rvio, bvio) at w;
  2. kkt            blocks.Assembler's KKT blocks at (w, mu);
  3. ldu            the plain LDU (ldu.py factorize, solve_refine with the
                    options' refine sweeps) on dojo_tpu's own blocks and -r;
  4. step           the port's iteration (solver.py: the predictor-corrector
                    step, the line search, the stall exit) from dojo_tpu's
                    iterate: its next w, (rvio, bvio) and mu, and its branches:
                    the line search's accepted step length alpha / 2^scale
                    (read from w' - w along the step), both packages'
                    convergence test at dojo_tpu's next iterate, the
                    no-progress count, the undercut (the stall exit) and done
                    (a lane done unconverged goes to the rescue);
  5. re-centering   the warm-onset re-centering (core.py
                    SolverOptions.warm_onset_*) runs only with a warm start
                    (w_prev), which these steps do not take: the script says so.

A float piece differs when max|port - dojo_tpu| exceeds --ulps float32 ulps
of max|dojo_tpu| (the vector's scale); a branch differs when its value does.
Prints one line an iteration (each piece's distance in ulps), then the first
piece that differs and the first branch that differs, and one JSON line with
all of it.  Also the first operations whose bits differ at all, at the
step's start: the context's previous configuration (x1 = x - v h,
dojo_tpu/lie.py next_position; q1 = q ∘ φ(-ω) h/2, next_orientation and
qmul) and, at the first iterate, each body's q2 ∘ φ(ω25) (the body rows'
q3), dojo_tpu's jitted against the port's, with whether XLA's fused
multiply-add (fma(-v, h, x); qmul's first component as fma(aw, bw,
-ax·bx), the other products rounded apart) gives dojo_tpu's bits where
they differ.  Runs on the CPU and imports both packages, as the tests do;
a case takes minutes (XLA compiles).
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
from dojo_tpu.cachedir import repo_cache_dir  # noqa: E402

jax.config.update("jax_compilation_cache_dir", repo_cache_dir("local"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dojo_tpu import lie as jlie  # noqa: E402
from dojo_tpu import models as jmodels  # noqa: E402
from dojo_tpu.blocks import make_assembler  # noqa: E402
from dojo_tpu.core import SolverOptions  # noqa: E402
from dojo_tpu.graph import build_schedule as j_build_schedule  # noqa: E402
from dojo_tpu.ldu import make_ldu  # noqa: E402
from dojo_tpu.residual import make_context, make_residual  # noqa: E402
from dojo_tpu.simulate import make_step  # noqa: E402
from dojo_tpu.solver import make_solver  # noqa: E402
from dojo_tpu_torch import ldu as TL  # noqa: E402
from dojo_tpu_torch import lie as tlie  # noqa: E402
from dojo_tpu_torch import models  # noqa: E402
from dojo_tpu_torch.blocks import Assembler  # noqa: E402
from dojo_tpu_torch.core import BodyState  # noqa: E402
from dojo_tpu_torch.core import SolverOptions as TOpts  # noqa: E402
from dojo_tpu_torch.graph import build_schedule  # noqa: E402
from dojo_tpu_torch.residual import Residual  # noqa: E402
from dojo_tpu_torch.residual import make_context as t_make_context  # noqa: E402
from dojo_tpu_torch.solver import make_solver as t_make_solver  # noqa: E402

OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)  # bench_zoo's, as the test's
EPS32 = float(np.finfo(np.float32).eps)
PIECES = ("residual", "violations", "kkt", "ldu", "step_w", "step_rv_bv", "step_mu")


def _f32(t):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, t)


def ulps(got, want):
    """max|got - want| in float32 ulps of max|want| (inf where got is not
    finite and want is)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all() and np.isfinite(want).all():
        return float("inf")
    scale = max(float(np.abs(want).max(initial=0.0)), np.finfo(np.float32).tiny)
    return float(np.abs(got - want).max(initial=0.0) / (EPS32 * scale))


def case(name, k, tol):
    """Feed dojo_tpu's iterates of step k of `name` to the port's pieces.
    Returns a dict: per iteration each piece's distance (ulps) or branch
    pair, and the first piece that differs."""
    jmech = jmodels.get_mechanism(name)
    jmech.params = _f32(jmech.params)
    start = chip_smoke.zoo_state(name, "cpu")
    jstate = type(jmech.zero_state())(**{f: jnp.asarray(getattr(start, f).numpy())
                                         for f in ("x", "q", "v", "w")})
    jopts = SolverOptions(**OPTS)
    jstep = jax.jit(lambda p, s: make_step(jmech.topo, jopts)(p, s, None))
    infos = []
    for _ in range(k + 1):  # the step's own outcome, then its start state
        nxt, info = jstep(jmech.params, jstate)
        infos.append(info)
        if len(infos) <= k:
            jstate = nxt
    want = (bool(infos[k].success), int(infos[k].iterations), bool(infos[k].rescued))

    topo, params = jmech.topo, jmech.params
    ctx = jax.jit(lambda s, p: make_context(topo, s, p))(jstate, params)  # as the step does
    init_w, solve, violations = make_solver(topo)
    # the body and violations with the context and parameters as arguments,
    # as the jitted step has them (closed over, XLA would fold them)
    it_ = lambda c, p: solve.make_iteration(c, p, jopts)
    with jax.default_matmul_precision("highest"):
        w0 = jax.jit(lambda v, w, p: init_w(v, w, p))(jstate.v, jstate.w, params)
        jviol_cp = jax.jit(lambda w, c, p: it_(c, p)[1](w))
        jbody_cp = jax.jit(lambda st, c, p: it_(c, p)[0](st))
        jviol = lambda w: jviol_cp(w, ctx, params)
        jbody = lambda st: jbody_cp(st, ctx, params)
        jres = jax.jit(make_residual(topo))
        jsched = j_build_schedule(topo)
        jasm = jax.jit(make_assembler(topo, jsched))
        _, jfact, jsolve, jmatvec = make_ldu(jsched)

        def _lin(blocks, rhs):
            fact = jfact(blocks)
            x = jsolve(fact, rhs)
            for _ in range(jopts.refine):
                x = x + jsolve(fact, rhs - jmatvec(blocks, x))
            return x

        jlin = jax.jit(_lin)
        rv0, bv0 = jviol(w0)

    tmech = models.get_mechanism(name, device="cpu").cast(torch.float32)
    tstate = BodyState(**{f: torch.as_tensor(np.asarray(getattr(jstate, f)))[None]
                          for f in ("x", "q", "v", "w")})
    tctx = t_make_context(tmech.topo, tstate, tmech.params)
    topts = TOpts(**OPTS)
    _, tsolve, tviol = t_make_solver(tmech.topo, device="cpu")
    tbody = tsolve.make_iteration(tctx, tmech.params, topts)
    tres = Residual(tmech.topo, "cpu")
    sched = build_schedule(tmech.topo)
    tasm = Assembler(tmech.topo, sched, "cpu")
    plan = TL.LduPlan(sched, "cpu")
    D = tmech.topo.dim
    rvw = tsolve_weights(tmech, tsolve)

    T = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt)[None]
    st = (w0, rv0, bv0, jnp.asarray(0.0, w0.dtype), jnp.asarray(jopts.undercut, w0.dtype),
          jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
          (rv0 < jopts.rtol) & (bv0 < jopts.btol))
    rows, first, first_branch = [], None, None
    om25 = np.asarray(w0, np.float32)[: 6 * topo.nb].reshape(topo.nb, 6)[:, 3:]
    bits = {"context_x1": position_contraction(ctx.x1, jstate.x, jstate.v, params.timestep,
                                               tctx.x1[0]),
            "context_q1": qmul_contraction(jstate.q, -np.asarray(jstate.w), params.timestep,
                                           tstate.q[0]),
            "body_rows_q3": qmul_contraction(ctx.q2, om25, params.timestep, tctx.q2[0])}
    for it in range(jopts.max_iter):
        if bool(st[7]):
            break
        w, rv, bv, mu, ucut, noprog, _, _ = st
        with jax.default_matmul_precision("highest"):
            r = jres(w, ctx, params, mu)
            blocks = jasm(w, ctx, params, mu)
            x = jlin(blocks, -r)
            st2 = jbody(st)
        tw, tmu = T(w), T(mu)
        row = {"iteration": it}
        row["residual"] = ulps(tres(tw, tctx, tmech.params, tmu)[0], r)
        trv, tbv = tviol(tw, tctx, tmech.params, rvw, oact_of(tmech, tsolve))
        row["violations"] = max(ulps(trv, rv), ulps(tbv, bv))
        row["rvio_bvio"] = [[float(rv), float(trv[0])], [float(bv), float(tbv[0])]]
        row["kkt"] = ulps(tasm(tw, tctx, tmech.params, tmu)[0, : sched.n_slots], blocks)
        tb = torch.as_tensor(np.asarray(blocks))[None].contiguous()
        fact = TL.factorize(plan, tb)
        rhs = TL.flat_to_nodes(plan, torch.as_tensor(np.asarray(-r))[None]).contiguous()
        xs = TL.solve(plan, fact, rhs)
        for _ in range(topts.refine):
            xs = xs + TL.solve(plan, fact, rhs - TL.matvec(plan, tb, xs))
        row["ldu"] = ulps(TL.nodes_to_flat(plan, xs, D)[0], x)
        tst = (tw, T(rv), T(bv), tmu, T(ucut), T(noprog, torch.int32), T(st[6], torch.int32),
               T(st[7]))
        out = tbody(tst)
        jw2, tw2 = np.asarray(st2[0], np.float64), out[0][0].numpy().astype(np.float64)
        row["step_w"] = ulps(tw2, jw2)
        row["step_rv_bv"] = max(ulps(out[1][0], st2[1]), ulps(out[2][0], st2[2]))
        row["step_mu"] = ulps(out[3][0], st2[3])
        # the step length the line search accepted, alpha / 2^scale, along
        # dojo_tpu's direction: (w' - w) . d / d . d with d = w' - w of
        # dojo_tpu's (1 for dojo_tpu itself; omega clamps aside)
        dj = jw2 - np.asarray(w, np.float64)
        dd = float(dj @ dj)
        ratio = float((tw2 - np.asarray(w, np.float64)) @ dj / dd) if dd > 0 else 1.0
        row["step_length"] = [1.0, ratio]
        # both packages' rvio at dojo_tpu's next iterate (the same bits): the
        # residual's rounding alone, and on which side of rtol each falls
        w2 = st2[0]
        with jax.default_matmul_precision("highest"):
            rj = np.asarray(jres(w2, ctx, params, 0.0), np.float64)
        rt = tres(T(w2), tctx, tmech.params, 0.0)[0].numpy().astype(np.float64)
        wgt = rvw.numpy().astype(np.float64)
        row["rvio_at_next"] = [float(np.abs(rj * wgt).max()), float(np.abs(rt * wgt).max())]
        # dojo_tpu's own violations at its next iterate, jitted apart from
        # the body, against the body's (rv2, bv2) of the same iterate
        jv2 = jviol(w2)
        row["own_violations_at_next"] = [[float(st2[1]), float(jv2[0])],
                                         [float(st2[2]), float(jv2[1])]]
        row["converged_at_next"] = [bool(row["rvio_at_next"][0] < jopts.rtol),
                                    bool(row["rvio_at_next"][1] < jopts.rtol)]
        top = np.argsort(-np.abs((rt - rj) * wgt))[:3]
        row["rows_at_next"] = [[int(i), row_name(tmech.topo, int(i)), float(rj[i]), float(rt[i])]
                               for i in top]
        row["no_progress"] = [int(st2[5]), int(out[5][0])]
        row["undercut"] = [float(st2[4]), float(out[4][0])]
        row["done"] = [bool(st2[7]), bool(out[7][0])]
        rows.append(row)
        if first is None:
            bad = [p for p in PIECES if row[p] > tol]
            if bad:
                first = {"iteration": it, "piece": bad[0], "value": row[bad[0]]}
        if first_branch is None:  # step_length: another halving of the step
            bad = [p for p in BRANCHES if ((abs(row[p][1] - 1.0) > 0.25) if p == "step_length"
                                           else row[p][0] != row[p][1])]
            if bad:
                first_branch = {"iteration": it, "branch": bad[0], "value": row[bad[0]]}
        print(f"{name} step {k} iteration {it}: "
              + ", ".join(f"{p} {row[p]:.3g}" for p in PIECES) + ", "
              + ", ".join(f"{p} {row[p]}" for p in BRANCHES)
              + f"; (rvio, bvio) at w {row['rvio_bvio']}; dojo_tpu's body "
            f"and its own violations at the next iterate {row['own_violations_at_next']}; "
            f"rvio at the next iterate {row['rvio_at_next']}, "
            f"rows {row['rows_at_next']}", flush=True)
        # advance on dojo_tpu's iterate (finished lanes frozen, as solve.traced)
        st = st2
    return {"model": name, "step": k, "dojo_tpu (success, iterations, rescued)": want,
            "iterations_of_the_jitted_body": len(rows),
            "body_converged": bool(st[1] < jopts.rtol and st[2] < jopts.btol),
            "first_difference": first, "first_branch": first_branch,
            "first_bits": bits, "iterations": rows,
            "warm_onset": "not on this path (no w_prev)"}


BRANCHES = ("step_length", "converged_at_next", "no_progress", "undercut", "done")


def qmul_contraction(jq2, om, h, tq2):
    """Each body's q ∘ φ(ω): dojo_tpu's jitted lie.qmul against the port's
    on the same q and φ, and whether the first component with its first
    product pair fused (fma(aw, bw, -ax·bx), the rest rounded apart) is
    dojo_tpu's.  Returns {"bodies", "differ", "ulps", "fma_reproduces"}."""
    f32 = np.float32
    phi = jax.jit(jlie.quaternion_map)(jnp.asarray(om), h)
    jq = np.asarray(jax.jit(jlie.qmul)(jq2, phi))
    tq = tlie.qmul(tq2, torch.as_tensor(np.asarray(phi))).numpy()
    differ = np.flatnonzero((jq != tq).any(-1))
    fused = 0
    for i in differ:
        (aw, ax, ay, az), (bw, bx, by, bz) = np.asarray(jq2[i], f32), np.asarray(phi[i], f32)
        c0 = f32(np.float64(aw) * np.float64(bw) - np.float64(f32(ax * bx)))
        c0 = f32(f32(c0 - f32(ay * by)) - f32(az * bz))
        fused += int(c0 == jq[i, 0] and tq[i, 0] != jq[i, 0])
    gap = np.abs(jq.astype(np.float64) - tq) / np.spacing(np.abs(jq).astype(np.float32))
    return {"bodies": int(jq.shape[0]), "differ": differ.tolist(), "ulps": float(gap.max()),
            "fma_reproduces": fused}


def position_contraction(jx1, x, v, h, tx1):
    """The context's x1 = x + (-v) h: dojo_tpu's jitted entries against the
    port's, and whether fma(-v, h, x) is dojo_tpu's where they differ."""
    jx1, tx1 = np.asarray(jx1), tx1.numpy()
    x, v, h = np.asarray(x, np.float64), np.asarray(v, np.float64), float(np.asarray(h))
    fused = (x + (-v) * np.float32(h)).astype(np.float32)  # exact product, one rounding
    differ = np.argwhere(jx1 != tx1)
    return {"entries": int(jx1.size), "differ": len(differ),
            "fma_reproduces": int(sum(fused[tuple(i)] == jx1[tuple(i)] for i in differ))}


def row_name(topo, i):
    """What row i of the residual is: a body's linear or angular dynamics, a
    joint's rows, a contact's."""
    if i < 6 * topo.nb:
        return f"body {i // 6} {'linear' if i % 6 < 3 else 'angular'} dynamics {i % 3}"
    if i < topo.contact_off:
        return f"joint {(i - topo.joint_off) // topo.jw} row {(i - topo.joint_off) % topo.jw}"
    return f"contact {(i - topo.contact_off) // topo.cw} row {(i - topo.contact_off) % topo.cw}"


def tsolve_weights(tmech, tsolve):
    """rvio row weights of the port's solver (its violations take them)."""
    return _closure(tsolve.make_iteration, "rvio_weights")(tmech.params)


def oact_of(tmech, tsolve):
    return _closure(tsolve.make_iteration, "ort_activity")(tmech.params)


def _closure(fn, name):
    """The function `name` that `fn` closes over (the port's solver keeps
    rvio_weights and ort_activity in make_solver's scope)."""
    for cell, var in zip(fn.__closure__ or (), fn.__code__.co_freevars):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="cartpole:1,hopper:2")
    ap.add_argument("--ulps", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out = []
    for c in a.cases.split(","):
        name, k = c.split(":")
        res = case(name, int(k), a.ulps)
        f, b = res["first_difference"], res["first_branch"]
        print(f"{name} step {k}: first piece that differs: "
              + (f"{f['piece']} at iteration {f['iteration']} ({f['value']})" if f else "none")
              + "; first branch that differs: "
              + (f"{b['branch']} at iteration {b['iteration']} ({b['value']})" if b else "none")
              + f"; first bits that differ: {res['first_bits']}",
              flush=True)
        out.append(res)
    line = json.dumps({"ulps": a.ulps, "cases": out})
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
