#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with elapsed seconds:
  device   — card name, and name + power limit from nvidia-smi;
  build    — nvcc builds of dojo_tpu_torch/csrc/ldu.cu for float32 and
             for float64 and of csrc/ldu_lane.cu (the kernels for a lane
             over a CTA) for each dtype and kernel, the eight nvcc
             processes at once, with each one's seconds; the packed
             factorize's two, the longest, go on while the phases up to
             atlas run (build_late: the wait for them before atlas);
  kernels  — the three block-LDU kernels against their plain PyTorch
             versions on the quadruped KKT at B=256, float32 (factorize
             also on L·U = PS·D, and each block LU bitwise against the
             plain one's on the blocks the kernel factored; the solve
             unrefined on the kernel's factors and refined once; each
             limit checked to reject a control off by ~1e-3), with times at
             B=256 and for one lane, and the dynamic shared memory each
             kernel was launched with;
  lu_swap  — each width class's factorize on blocks whose pivots cancel
             to rounding noise only through the arithmetic row swap
             (swap_blocks), bitwise against the plain block LU;
  steps    — the quadruped contact step (h=0.05, B=256, float32,
             rtol=1e-6, btol=1e-4, max_iter=30): one validation step, then
             a cold and a warm chain as bench.py runs them (one untimed
             step, then K timed steps; the cold chain passes the neutral
             init as w_prev, the warm one the previous solution), with
             success, Newton iterations, rescued lanes, steps/s and kernel
             launch counts;
  profile  — one warm step under torch.profiler: CUDA kernels launched,
             device busy share, and the top CPU operators by self time;
  reference— lane 0 of the validation step against one float64 step of the
             same state through the plain path on the CPU;
  mpc      — one control step of bench.py's phase "mpc" (rt, H=40, B=32
             scenarios, α ∈ {1, 0.5, 0.25, 0.1}, float32): make_trot_rt's
             rollout, linearize (54 tangent columns per knot against one
             factorization), Riccati pass and α-batched forward pass, then
             the plant step; wall ms per part, Newton iterations, rescued
             lanes, okf, costs, best-α counts, sanitized knots, kernel
             launches and peak memory.  It also holds solve and matvec
             with a shared factorization (1,280 knots × 54 columns: the
             W ≤ 16 shared-factor solve kernel, alone and refined once, and
             the staged matvec) to their plain versions, with times, bounds
             and the BSR product
             (mpc_shared_factor); the float32 linearize on the card to the
             plain float64 linearize on the CPU at 4 of the controller's
             knots (mpc_linearize); and at up to 12 plant knots (μ = 1e-5,
             tests/test_torch_linearize_f32_ref.py's lanes stepped on the
             card) the card's smallest pivots (none at the floor) and
             linearize errors against the plain float32 CPU's
             (mpc_linearize_plant).
  zoo      — bench_zoo.py's 12 models (B=64, float32, default timestep,
             u=None), each from its initial state: the model's KKT through
             its width class's kernels (W ≤ 16, 17–32, 33–72) against the
             plain versions, with times and bounds, then ZOO_K timed steps
             (on ZOO_FAILS_B lanes for the six models dojo_tpu fails too)
             with success, Newton iterations, rescued lanes, steps/s and
             the launches of each kernel of the class;
             then (zoo_kkt)
             humanoid's and block's KKTs in float64 (their lanes fit a CTA
             only at the factorize's real widths), twister's in float32,
             and those of the ten other scheduled models of dojo_tpu's zoo
             (quadrotor and block2d on 33–72, uuv on 17–32) through their
             class's kernels against the plain versions, block LUs bitwise,
             with times and both bounds.
  atlas    — atlas's drop (a lane over a CTA's shared memory at its real
             rows): its KKT through the kernels of csrc/ldu_lane.cu (the
             packed factorize and solve, the lane matvec) against the
             plain versions (float32, B=64, kernels-line rows
             factorize_packed, solve_packed, matvec_lane; float64, B=8,
             atlas_kkt), with the variant each kernel takes; then one
             float32 step on 8 lanes (not gated: dojo_tpu fails it too) and
             ATLAS_K float64 steps on 32 lanes held to success, the
             smallest signed distance and finite states.
  diff     — the differentiable step (gradients.make_diff_step*: the IFT
             as a torch.autograd.Function) on the quadruped at bench.py's
             options, float32, B=64 lanes with their own inputs, T=2
             steps: (a) backward into every step's inputs,
             contact_friction and mass, every lane of every forward solve
             converged (rescued lanes counted); (b) forward mode
             (torch.func.jvp) over the first step against the reverse mode
             of the same loss along a seeded direction, also in float64 on
             8 lanes; (c)
             minimal_jacobians (dense LU) against linearize (the k = 54
             shared-factor kernels) at step 1's solution, on its 64 lanes,
             the rescued ones reported apart; (d) the sphere's jvp in v0
             against central differences, float64, 16 lanes; (e)
             solve.traced against solve, with the per-iteration medians
             (diff_trace); each part's seconds, errors and limits.
Then one {"kernels": [...]} line (a row per kernel and width class, the
17–32 rows on humanoid's KKT and again on walker's (<kernel>_w17_32_walker),
and the rows solve_shared and matvec_shared of k = 54 right-hand sides a
factorization, with the launches of each row's kernel on the steps chains,
in the control step as launches_mpc, in the zoo's timed steps as
launches_zoo (the class's, over every model; launches_zoo_model: on the
row's model), in the atlas phase's steps as launches_atlas and in the diff
phase as launches_diff; bound_ms counts
W-wide blocks, bound_ms_real each node's real width), the nvidia-smi line,
and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the exit code is
non-zero and the last line is not printed.  Without a CUDA device, or
without the repository beside it, the script fails.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
T0 = time.perf_counter()
B = 256  # lanes, as bench.py phase "steps"
K = 3  # steps per chain
MPC_B, MPC_H, MPC_DT = 32, 40, 0.05  # bench.py phase "mpc": scenarios, horizon, dt
ALPHAS = (1.0, 0.5, 0.25, 0.1)
# bench_zoo.py's MODELS, its lanes, and the steps timed per model.  bench_zoo
# steps 1 simulated second (100 steps at h=0.01, 20 for ant at h=0.05); here
# one: 6 of the 12 models stall in float32 at rtol=1e-6 (in dojo_tpu too),
# and a stalled step runs the dense rescue to max_iter, 13-58 s of host time
# a step beside an H100, where K=5 had not finished 10 of the 12 models
# after 1,085 s (PERF.md §4).  The gate below holds only this first step.
# At K=5 cartpole's success read 0.8 and block's 0.6 on the card, which
# fails it; dojo_tpu in float32 from the same state fails cartpole's step 4
# and block's step 3 (PERF.md §6), but tests/test_torch_zoo_f32_ref.py
# holds the exemptions to it at K=1 only.  Raise K only with the success
# of each step held to dojo_tpu's (ROADMAP Queue 3)
ZOO_MODELS = ("pendulum", "npendulum", "cartpole", "block", "sphere", "snake", "hopper",
              "halfcheetah", "walker", "ant", "quadruped", "humanoid")
ZOO_B, ZOO_K = 64, 1
# models that dojo_tpu itself, in float32 on the CPU, fails to step at these
# options within the ZOO_K timed steps from the same state (zoo_state): the
# zoo phase does not hold them to success >= 0.9
# (tests/test_torch_zoo_f32_ref.py holds this set to the reference at
# ZOO_K = 1 only; PERF.md records each)
ZOO_REFERENCE_FAILS = frozenset({"npendulum", "snake", "hopper", "halfcheetah", "walker",
                                 "humanoid"})
# the model whose KKT times each width class's kernels in the kernels line
CLASS_MODEL = {"w16": "quadruped", "w32": "humanoid", "w72": "block"}
CLASS_NAME = {"w16": "", "w32": "_w17_32", "w72": "_w33_72", "packed": "_packed",
              "lane": "_lane"}
# the variant each kernel takes on atlas's lane (ldu_cuda.variant), both dtypes
ATLAS_VARIANTS = {"factorize": "packed", "solve": "packed", "matvec": "lane"}
# further models whose KKT times their class's kernels, with rows of their
# own (<kernel><class>_<model>): walker's nodes are 14 wide, humanoid's 6
ROW_MODELS = {"walker": "w32"}
# KKTs the zoo phase also holds to the plain versions: humanoid's and
# block's lanes in float64 (they fit a CTA only at real widths), twister
# (W=22, not in bench_zoo's models), and the models of dojo_tpu's zoo that
# are not in bench_zoo's and have an elimination schedule (fourbar's loop
# has none): quadrotor (W=70) and block2d (W=38) on the 33..72 kernels, uuv
# (W=22) on the 17..32 kernels, the rest on the W <= 16 kernels (atlas: the
# atlas phase)
ZOO_KKT_EXTRA = (("humanoid", "float64"), ("block", "float64"), ("twister", "float32"),
                 ("quadrotor", "float32"), ("block2d", "float32"), ("uuv", "float32"),
                 ("dzhanibekov", "float32"), ("tippetop", "float32"),
                 ("raiberthopper", "float32"), ("panda", "float32"), ("youbot", "float32"),
                 ("exoskeleton", "float32"))
# the lanes of the timed step of a model of ZOO_REFERENCE_FAILS: each of the
# six stalls to max_iter and runs the dense rescue, 26-56 s a step on the
# card whatever the lanes (8 or 64: host time); its KKT is still checked at
# ZOO_B
ZOO_FAILS_B = 8
# phase atlas: atlas dropped from ATLAS_LIFT above its standing height with
# joint springs and dampers (tests/test_behaviors.py test_atlas_drop_balance,
# BASELINE.json's "Atlas humanoid balance/drop"); (a) its KKT through the
# kernels for a lane over a CTA against the plain versions in float32 at
# ATLAS_B lanes and float64 at ATLAS_B64; (b) ATLAS_K steps (0.1 s of the
# JAX test's 1 s) in float64, the JAX test's dtype, on ATLAS_STEP_B lanes,
# held to its gates over this shorter window: success, the smallest signed
# distance, finite states; before them ATLAS_K32 float32 step on ATLAS_B32
# lanes, whose success is not gated: at these options dojo_tpu fails every
# float32 step too, its solve stalling at rvio ~5e-4
# (tests/test_torch_zoo_f32_ref.py test_reference_float32_atlas_drop), and
# each step runs to max_iter and the dense rescue; it runs the float32
# path's refinement sweeps, the only launches of the matvec (float64 solves
# take none)
ATLAS_B, ATLAS_B64, ATLAS_STEP_B, ATLAS_K, ATLAS_LIFT = 64, 8, 32, 10, 0.02
ATLAS_B32, ATLAS_K32 = 8, 1
ATLAS_OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)
ATLAS_SUCCESS, ATLAS_MIN_SDF = 0.9, -5e-4
# float32 linearize on the card against the plain float64 one on the CPU,
# max(|ΔA|, |ΔB|) / max(1, |A|∞) at knots of the controller's rollout: the
# same comparison with the float32 plain path on the CPU gave at most
# 2.33e-5 over the 32 knots of a B=8, H=4 rollout; the tolerance is 10x that
LIN_TOL = 2.5e-4
# float32 linearize at the plant's own knots (μ = 1e-5), where the port's
# float32 block LU once floored a pivot that cancelled to 0
# (tests/test_torch_linearize_f32_ref.py): that test's 32 perturbed lanes
# with random inputs (numpy seed 0), stepped on the card, and at most
# PLANT_KNOTS of the converged knots, linearized on the card and, plain, on
# the CPU in float32 and float64 (~1.5 s of CPU a knot)
PLANT_LANES, PLANT_KNOTS = 32, 12
PLANT_OPTS = dict(rtol=1e-6, btol=1e-4, max_iter=30)
# phase diff: the quadruped at bench.py's options, float32, DIFF_B lanes of
# T steps, each lane with its own inputs (DIFF_U_SCALE·N(0, 1) per actuated
# coordinate); the float64 run of its forward/reverse check on DIFF_B64
# lanes; minimal_jacobians against linearize on step 1's DIFF_B lanes; the
# sphere's jvp against central differences on DIFF_FD_LANES lanes.  The
# reverse check (a) takes DIFF_T steps, so that gradients flow from a later
# step into an earlier one (DIFF_T_FULL before the atlas phase); the
# forward check (b) takes DIFF_T_FWD, against the reverse mode of the same
# steps
DIFF_B, DIFF_T, DIFF_T_FWD, DIFF_B64, DIFF_FD_LANES = 64, 2, 1, 8, 16
DIFF_T_FULL = 3
# the float64 forward/reverse check takes one step (three took 45 s of host
# time on the card, PR 12): the call's time limit
DIFF_T64 = 1
DIFF_U_SCALE, DIFF_FD_EPS, DIFF_FD_ATOL = 0.1, 1e-5, 1e-4
# (d)'s solves run to max_iter 100: at rtol = btol = 1e-8 the sphere 2 cm
# over the ground takes 21-54 iterations over v0 in 0.5-2.0 m/s (float64,
# the CPU and the card alike, PR 12), and at the default 50 three of the 16 lanes
# stop short, where the relaxed solution's jvp is no derivative of the
# unconverged map
DIFF_FD_ITERS = 100
# limits, relative: (b) |forward − reverse| / Σ|∂L/∂θᵢ dᵢ|, the same check
# on the CPU's plain path at B = 8 reading 1.8e-8 in float32 and 1.6e-16 in
# float64; (c) max(|ΔA|, |ΔB|) / max(1, |A|), as mpc_linearize scales its
# own, 4.6e-5 on the CPU at those 8 lanes, 3 of them rescued (about 10x:
# DIFF_JAC_TOL); (e) solve.traced's
# w against solve's on the lanes solve did not rescue, relative to max|w|
# (bitwise equal on the CPU)
DIFF_FWD_TOL = {"torch.float32": 1e-5, "torch.float64": 1e-8}
# the share of a step's lanes whose forward solve must converge (the dense
# rescue included), the steps phase's gate: the plain path on the CPU and
# the H100 each leave 1 of the 64 lanes of (a)'s third step unconverged,
# and such a lane's gradient is the relaxed problem's, as in dojo_tpu
DIFF_SUCCESS = 0.9
DIFF_JAC_TOL, DIFF_TRACE_TOL = 5e-4, 1e-6
H100 = {"bytes_per_s": 3.35e12, "f32_flops": 67e12, "f64_flops": 34e12}


def build_report(built):
    """ldu_cuda.start_builds' results as phase build prints them: per
    library and dtype, its file, seconds and ptxas lines."""
    return {f"{name}:{'float32' if elem == 4 else 'float64'}": dict(
        library=os.path.basename(path), seconds=round(sec, 3),
        ptxas=[ln.strip() for ln in report.splitlines()
               if any(w in ln for w in ("registers", "spill", "Compiling"))])
        for (name, elem), (path, report, sec) in built.items()}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps, spin=True):
    """Mean device time of one call of fn, over reps calls after a warm-up.

    A spin kernel holds the stream while the calls are enqueued, so the
    CUDA events time the calls back to back on the device rather than the
    host's launch overhead (as long as a call's launches fit the queue).
    Where the spin ended before the host had enqueued every call (the host
    slowed), the device waited on the host: the run is made again with a
    spin twice as long, up to four times (counted in time_ms.redone).
    With spin=False (the plain versions, whose thousands of launches a call
    overflow the queue: the host then waits out any spin, and each run
    would be made again to no end) the calls are timed back to back with
    no spin, the device's waits on the host included."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    fn()
    torch.cuda.synchronize()
    if not spin:
        start, end = events()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start, end = events()
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    torch.cuda.synchronize()
    cycles_per_s = 10**7 / (start.elapsed_time(end) / 1e3)
    for attempt in range(4):
        start, end = events()
        torch.cuda._sleep(int(2 ** (attempt + 1) * enqueue_s * cycles_per_s) + 10**5)
        start.record()
        for _ in range(reps):
            fn()
        drained = start.query()  # the spin ended before every call was enqueued
        end.record()
        torch.cuda.synchronize()
        if not drained:
            break
        time_ms.redone += 1
    return start.elapsed_time(end) / reps


time_ms.redone = 0  # runs made again because the spin ended first


def work(sched, lanes, elem, k=1):
    """(bytes, flops) each kernel must move / execute for `lanes` lanes
    (factorizations), with k right-hand sides each for solve and matvec.

    Bytes count each input read once and each output written once; flops
    count the arithmetic of the algorithm as the kernels execute it (pad
    rows included)."""
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    lu = sum(sum(1 + 2 * (W - 1 - k) * (W - 1 - k) + (W - 1 - k) for k in range(lv.real_w))
             + W * W for lv in sched.levels for _ in lv.nodes)
    upd = sum(len(lv.upd_tgt) for lv in sched.levels) * (6 * W**3 + 2 * W * W)
    node_solve = 4 * W * W
    fwd = sum(len(lv.nodes) * node_solve + 2 * W * W * len(lv.fwd_a)
              for lv in sched.levels if len(lv.fwd_a))
    bwd = sum(len(lv.nodes) * node_solve + 2 * W * W * len(lv.bwd_i) for lv in sched.levels)
    edges = {int(s) for lv in sched.levels for s in list(lv.fwd_ai) + list(lv.bwd_ia)}
    return {
        "factorize": (elem * lanes * (2 * S * W * W + 2 * N * W * W), lanes * (lu + upd)),
        "solve": (elem * lanes * ((len(edges) + 2 * N) * W * W + 2 * k * N * W),
                  lanes * k * (fwd + bwd)),
        "matvec": (elem * lanes * (S * W * W + 2 * k * N * W), lanes * k * 2 * S * W * W),
    }


def work_real(sched, lanes, elem, k=1):
    """work() counted at each node's real width: what these inputs need.
    Bytes read each block's real part once (the pad of a block from the
    assembler is known: zero, identity on the diagonal) and write each
    output whole (fb, LU, PS and node vectors are W wide); flops count
    each node's LU, X, Schur product and substitution over its real rows
    and columns, in the terms work() uses at W."""
    W, N = sched.width, sched.n_nodes
    nw = [int(n) for n in sched.node_width]
    rc = {s: (nw[a], nw[b]) for (a, b), s in sched.slot.items()}
    real = sum(a * b for a, b in rc.values())
    lu = sum(sum(1 + 2 * (n - 1 - j) ** 2 + (n - 1 - j) for j in range(n)) + n * n
             for n in nw)
    upd = sum(4 * rc[int(ib)][0] ** 2 * rc[int(ib)][1] + 2 * rc[int(ai)][0] * rc[int(ai)][1]
              * rc[int(ib)][1] + 2 * rc[int(ai)][0] * rc[int(ib)][1]
              for lv in sched.levels for ai, ib in zip(lv.upd_ai, lv.upd_ib))
    solves = lambda nodes: sum(4 * nw[n] ** 2 for n in nodes)
    fwd = sum(solves(lv.nodes) + sum(2 * rc[int(s)][0] * rc[int(s)][1] for s in lv.fwd_ai)
              for lv in sched.levels if len(lv.fwd_a))
    bwd = sum(solves(lv.nodes) + sum(2 * rc[int(s)][0] * rc[int(s)][1] for s in lv.bwd_ia)
              for lv in sched.levels)
    edges = {int(s) for lv in sched.levels for s in list(lv.fwd_ai) + list(lv.bwd_ia)}
    diag = sum(n * n for n in nw)
    return {
        "factorize": (elem * lanes * (real + sched.n_slots * W * W + 2 * N * W * W),
                      lanes * (lu + upd)),
        "solve": (elem * lanes * (sum(a * b for s, (a, b) in rc.items() if s in edges)
                                  + 2 * diag + 2 * k * N * W), lanes * k * (fwd + bwd)),
        "matvec": (elem * lanes * (real + 2 * k * N * W), lanes * k * 2 * real),
    }


def lu_identity_err(fb, lu, ps, n_nodes):
    """max over lanes and nodes of |L·U − PS·D| / max|PS·D| (D = the
    node's diagonal block as factored, fb slot n)."""
    import torch

    W = lu.shape[-1]
    lower = torch.tril(lu, -1) + torch.eye(W, dtype=lu.dtype, device=lu.device)
    pd = ps @ fb[:, :n_nodes]
    num = (lower @ torch.triu(lu) - pd).abs().amax(dim=(-1, -2))
    return (num / pd.abs().amax(dim=(-1, -2))).max().item()


def swap_blocks(kind, seed, count=64, W=14, n=12):
    """Diagonal blocks (count, W, W), float32 numpy, from a seed: n real
    rows of widely spread scales (pad rows identity).  "dup": row j is a
    power of two times row i, so that after row scaling the two are equal
    and their pivot cancels exactly unless a row swap has rounded one of
    them; "prop": row j a random multiple of row i; "comb": row l a
    combination of rows i and j (pivots that cancel to rounding noise);
    "random": none of these."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = np.tile(np.eye(W, dtype=np.float32), (count, 1, 1))
    R = rng.standard_normal((count, n, n)) * np.exp(rng.normal(scale=2, size=(count, n, 1)))
    for b in range(count):
        i, j, l = rng.choice(n, 3, replace=False)
        if kind == "dup":
            R[b, j] = R[b, i] * 2.0 ** rng.integers(-2, 3)
        elif kind == "prop":
            R[b, j] = R[b, i] * rng.uniform(-3, 3)
        elif kind == "comb":
            R[b, l] = R[b, i] * rng.uniform(-3, 3) + R[b, j] * rng.uniform(-3, 3)
    D[:, :n, :n] = R.astype(np.float32)
    return D


def isolated_blocks(sched, kind, seed, lanes, device):
    """A schedule's blocks (lanes, S, W, W), float32, with each node's
    diagonal block from swap_blocks (the seed plus the node) and every edge
    block zero, so that each node's block is factored as made (its Schur
    updates subtract exact zeros).  A block's real width is its level's
    (the width the W ≤ 16 kernels pivot to), and in the 17–32 and 33–72
    classes, whose kernels factor each node at its own width and take its
    pad as the assembler makes it (identity), the node's."""
    import numpy as np
    import torch

    from dojo_tpu_torch.ldu_cuda import width_class

    W = sched.width
    own = width_class(W) != "w16"
    blocks = np.zeros((lanes, sched.n_slots, W, W), dtype=np.float32)
    for lv in sched.levels:
        for nd in lv.nodes:
            n = int(sched.node_width[nd]) if own else int(lv.real_w)
            blocks[:, nd] = swap_blocks(kind, seed + int(nd), lanes, W, n)
    return torch.as_tensor(blocks, device=device)


def ulp_gap(a, b):
    """The most units in the last place between two float32 (or float64)
    tensors' entries (their bit patterns as ordered integers)."""
    import torch

    def ordered(t):
        if t.dtype == torch.float64:
            i = t.contiguous().view(torch.int64)
            return torch.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def lu_vs_plain(sched, fb, lu, ps):
    """A factorization's block LUs against the plain block LU,
    ldu.blu_factor on the CPU, of the diagonal blocks as the factorization
    factored them (fb's slots 0..N-1), level by level at its real width:
    the arithmetic row swap and the Schur update rounded as
    ldu.schur_fma (in float32 dojo_tpu's blu_factor).  Float32 for every
    width class; float64 for the 17..32 and 33..72 classes, whose kernels
    round the float64 update as schur_fma does.  Returns a dict: blocks; ``differ``,
    the blocks whose LU or
    PS differ from the plain one's in any bit; ``ulps``, the most ulps an
    LU entry lies from the plain one's; ``floored``, the blocks whose
    smallest pivot sits at the floor where the plain one's does not;
    ``at_floor``, the blocks whose smallest pivot sits at the floor; and
    ``min_pivot``, the smallest |U_kk|."""
    import torch

    from dojo_tpu_torch import ldu

    fb, lu, ps = (t.cpu() for t in (fb, lu, ps))
    floor = ldu.pivot_floor(fb.dtype)
    out = dict(blocks=0, differ=0, ulps=0, floored=0, at_floor=0, min_pivot=float("inf"))
    for lv in sched.levels:
        nodes, n = torch.as_tensor(lv.nodes), int(lv.real_w)
        plu, pps = ldu.blu_factor(fb[:, nodes], n)
        klu, kps = lu[:, nodes], ps[:, nodes]
        piv = lambda t: t.diagonal(dim1=-2, dim2=-1)[..., :n].abs().amin(-1)
        out["blocks"] += klu.shape[0] * klu.shape[1]
        out["differ"] += int(((klu != plu) | (kps != pps)).flatten(2).any(-1).sum())
        out["ulps"] = max(out["ulps"], ulp_gap(klu, plu))
        out["floored"] += int(((piv(klu) <= floor) & (piv(plu) > floor)).sum())
        out["at_floor"] += int((piv(klu) <= floor).sum())
        out["min_pivot"] = min(out["min_pivot"], piv(klu).min().item())
    return out


def profile_summary(prof, top=8):
    """(device seconds, CUDA events, the top CPU operators by self time) of
    a finished torch.profiler run, read from its raw kineto events: the
    profiler's own FunctionEvents (prof.events(), key_averages()) take
    tens of seconds of host time to build for one step's ~350k events.  As
    there, a CPU operator's self time is its duration less its children's
    (nested per thread by start and end), and an operator whose parent has
    its name and no other child is folded into the parent."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    cuda = [e.duration_ns() for e in raw if e.device_type() == DeviceType.CUDA]
    cpu = sorted((e.start_thread_id(), e.start_ns(), -e.duration_ns(), e.name())
                 for e in raw if e.device_type() == DeviceType.CPU)
    parent, children, self_ns, stack = [], [0] * len(cpu), [], []
    end = lambda j: cpu[j][1] - cpu[j][2]
    for i, (tid, start, neg, _) in enumerate(cpu):
        while stack and (cpu[stack[-1]][0] != tid or end(stack[-1]) <= start):
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        if stack:
            children[stack[-1]] += 1
            self_ns[stack[-1]] += neg
        self_ns.append(-neg)
        stack.append(i)
    total, calls = {}, {}
    for i, (_, _, _, name) in enumerate(cpu):
        total[name] = total.get(name, 0) + self_ns[i]
        p = parent[i]
        folded = p >= 0 and cpu[p][3] == name and children[p] == 1
        calls[name] = calls.get(name, 0) + (not folded)
    ops = sorted(total, key=total.get, reverse=True)[:top]
    return (sum(cuda) / 1e9, len(cuda),
            [dict(op=n, calls=calls[n], self_cpu_ms=total[n] / 1e6) for n in ops])


def bound(nbytes, flops, dtype="float32"):
    t_b = nbytes / H100["bytes_per_s"]
    t_f = flops / H100["f64_flops" if dtype == "float64" else "f32_flops"]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def launch_counts():
    """Each LDU kernel's launches since the counts were last reset."""
    from dojo_tpu_torch import ldu_cuda as L

    return {fn.__name__: fn.launches for fn in (L.factorize, L.solve, L.matvec)}


def class_launch_counts():
    """Each LDU kernel's launches per width class since the last reset."""
    from dojo_tpu_torch import ldu_cuda as L

    return {fn.__name__: dict(fn.class_launches) for fn in (L.factorize, L.solve, L.matvec)}


def row_launch_counts():
    """Launches since the last reset per row of the kernels line: each
    kernel and variant (width class, "packed" or "lane") with one right-hand side a
    factorization, and as
    `solve_shared` / `matvec_shared` the W ≤ 16 launches with k > 1 (the
    shared-factor solve kernel, and the matvec at k columns)."""
    from dojo_tpu_torch import ldu_cuda as L

    rows = {}
    for fn in (L.factorize, L.solve, L.matvec):
        for cls in L.VARIANTS:
            rows[fn.__name__ + CLASS_NAME[cls]] = fn.class_launches[cls] - fn.shared_launches[cls]
        if fn is not L.factorize:
            rows[fn.__name__ + "_shared"] = fn.shared_launches["w16"]
    return rows


def model_kkt(mech, state, lanes, dev, init_w=None, seed=0):
    """A model's KKT blocks and right-hand side (node vectors) at `lanes`
    copies of `state`, at the neutral init (`init_w`, a step's, or a new
    solver's) plus 0.01 of noise from a seed, μ = 1e-3; returns (schedule,
    DeviceSchedule, blocks, rhs)."""
    import torch

    from dojo_tpu_torch import ldu_cuda as L
    from dojo_tpu_torch.blocks import make_assembler
    from dojo_tpu_torch.core import tensor_map
    from dojo_tpu_torch.graph import build_schedule
    from dojo_tpu_torch.residual import make_context, make_residual
    from dojo_tpu_torch.simulate import make_step

    topo, params = mech.topo, mech.params
    dtype = params.mass.dtype
    sched = build_schedule(topo)
    ds = L.DeviceSchedule(sched, dev)
    bstate = tensor_map(lambda a: a.expand(lanes, *a.shape).contiguous(), state)
    u = torch.zeros(lanes, topo.nj, 6, dtype=dtype, device=dev)
    ctx = make_context(topo, bstate, params, u)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w0 = (init_w or make_step(topo, device=dev).init_w)(bstate.v, bstate.w, params)
    bw = w0 + 0.01 * torch.randn(w0.shape, generator=gen, dtype=dtype).to(dev)
    mu = torch.full((lanes,), 1e-3, dtype=dtype, device=dev)
    blocks = make_assembler(topo, sched, dev)(bw, ctx, params, mu).contiguous()
    rhs = L.flat_to_nodes(ds.plan, make_residual(topo, dev)(bw, ctx, params, mu)).contiguous()
    return sched, ds, blocks, rhs


def control(t, seed=0):
    """t with each entry scaled by 1 + 1e-3·N(0, 1) (from a seed): an output
    off by about 1e-3, which every limit of check_kernels must reject."""
    import torch

    z = torch.randn(t.shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    return t * (1 + 1e-3 * z).to(t.device, t.dtype)


def check_kernels(ds, blocks, rhs, what):
    """The three kernels against their plain versions on one KKT.  Each
    limit lies between a sound kernel's reading and a control's (the plain
    output scaled by 1 + 1e-3·N(0, 1), which must fail it):
    - factored blocks to 2e-5 of max|fb| (float64: 1e-12); L·U = PS·D to
      1e-4 of |PS·D| (float64: 1e-12); each block LU bitwise equal to the
      plain one's on the blocks the kernel factored (lu_vs_plain: the
      arithmetic row swap and the Schur update rounded as ldu.schur_fma;
      float64 in the 17..32 and 33..72 classes only);
    - the solve alone, unrefined, on the kernel's factors (bitwise the
      plain ones') against the plain solve on the same factors: to
      max(2e-5, 4·e) of its scale, e the plain float32 solve's own error
      against float64 on those factors (float64: 1e-12); then solve + one
      refinement sweep to 2e-5 of its scale (float64: 1e-10) with a
      relative residual under 1e-4;
    - matvec to 1e-5·Σ|E||x| (the rounding of W float32 products and the
      slot sum).
    Returns (errors: "solve" is the unrefined solve's, "limits" each
    check's (reading, limit, control) relative to its scale; kernel
    factors, kernel solution, Σ|E||x| per entry)."""
    import torch

    from dojo_tpu_torch import ldu, ldu_cuda as L

    f64 = blocks.dtype == torch.float64
    check(not f64 or L.width_class(ds.sched.width) != "w16",
          f"{what}: float64 block LUs are bitwise the plain ones' in the real-width classes "
          "(17..72) only")
    tol_fb, tol_lu, tol_refined = (1e-12, 1e-12, 1e-10) if f64 else (2e-5, 1e-4, 2e-5)
    rel = lambda a, b, scale: (a - b).abs().max().item() / scale
    limits = {}

    def hold(name, reading, limit, ctl):
        limits[name] = (reading, limit, ctl)
        check(reading < limit, f"{what} {name}: {reading} of scale (limit {limit})")
        check(ctl > limit, f"{what} {name}: the control reads {ctl}, under the limit {limit}")

    fact_k = L.factorize(ds, blocks)
    fact_p = ldu.factorize(ds.plan, blocks)
    err_fact = (fact_k[0] - fact_p[0]).abs().max().item()
    fb_scale = fact_p[0].abs().max().item()
    hold("factorize", err_fact / fb_scale, tol_fb,
         rel(control(fact_p[0]), fact_p[0], fb_scale))
    # LU and PS may differ from the plain version's where pivot magnitudes
    # tie to rounding; the contract on them is L·U = PS·D for every node
    err_lu = lu_identity_err(*fact_k, ds.sched.n_nodes)
    check(err_lu < tol_lu, f"{what} factorize: L·U − PS·D is {err_lu} of |PS·D| ({tol_lu})")
    lu_plain = lu_vs_plain(ds.sched, *fact_k)
    check(lu_plain["differ"] == 0, f"{what} factorize: {lu_plain['differ']} of "
          f"{lu_plain['blocks']} block LUs differ from the plain one's, by up to "
          f"{lu_plain['ulps']} ulps")
    x0_k = L.solve(ds, fact_k, rhs)
    x0_p = ldu.solve(ds.plan, fact_k, rhs)
    scale0 = x0_p.abs().max().item()
    err_solve0 = (x0_k - x0_p).abs().max().item()
    if f64:
        tol_solve0 = 1e-12
    else:
        x0_64 = ldu.solve(ds.plan, [f.double() for f in fact_k], rhs.double())
        tol_solve0 = max(2e-5, 4 * rel(x0_p.double(), x0_64, scale0))
    hold("solve", err_solve0 / scale0, tol_solve0, rel(control(x0_p), x0_p, scale0))
    x_k = L.solve_refine(ds, blocks, fact_k, rhs, 1)
    x_p = ldu.solve(ds.plan, fact_p, rhs)
    x_p = x_p + ldu.solve(ds.plan, fact_p, rhs - ldu.matvec(ds.plan, blocks, x_p))
    scale = x_p.abs().max().item()
    err_solve = (x_k - x_p).abs().max().item()
    check(err_solve < tol_refined * scale,
          f"{what} solve refined: {err_solve} of scale {scale} ({tol_refined})")
    res = rhs - ldu.matvec(ds.plan, blocks, x_k)
    relres = (res.flatten(1).norm(dim=1) / rhs.flatten(1).norm(dim=1).clamp_min(1e-30)).max().item()
    check(relres < 1e-4, f"{what} solve: relative residual {relres} (1e-4)")
    y_k = L.matvec(ds, blocks, x_k)
    y_p = ldu.matvec(ds.plan, blocks, x_k)
    mag = ldu.matvec(ds.plan, blocks.abs(), x_k.abs())
    err_mv = (y_k - y_p).abs().max().item()
    check(bool(((y_k - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"{what} matvec: max error {err_mv} exceeds 1e-5·Σ|E||x|")
    errors = {"factorize": err_fact, "solve": err_solve0, "matvec": err_mv,
              "solve_refined": err_solve, "lu_identity": err_lu, "relres": relres,
              "solve_scale": scale, "lu_blocks": lu_plain["blocks"], "limits": limits}
    return errors, fact_k, x_k, mag


def bsr_matvec(ds, blocks, x, k=1):
    """The library yardstick of the matvec: one block-sparse (BSR) product
    over the block-diagonal-over-lanes matrix, blocks sorted by (row, col)
    node, times the k vectors of each lane as a dense (B·N·W, k) operand.
    Returns (call, its result as node vectors (B·k, N, W))."""
    import torch

    sched, dev = ds.sched, blocks.device
    B = blocks.shape[0]
    node_pair = {s: ab for ab, s in sched.slot.items()}
    perm = torch.as_tensor(sorted(node_pair, key=node_pair.get), device=dev)
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    col = ds.plan.slot_b[perm].repeat(B) + torch.arange(B, device=dev).repeat_interleave(S) * N
    counts = torch.bincount(ds.plan.slot_a, minlength=N).repeat(B)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    bsr = torch.sparse_bsr_tensor(crow, col, blocks[:, perm].reshape(B * S, W, W),
                                  size=(B * N * W, B * N * W))
    xv = x.reshape(B, k, N * W).transpose(1, 2).reshape(B * N * W, k).contiguous()
    y = (bsr @ xv).reshape(B, N * W, k).transpose(1, 2).reshape(B * k, N, W)
    return (lambda: bsr @ xv), y


REPLACES = {
    "factorize": "dojo_tpu/pallas_ldu.py:229",
    "solve": "dojo_tpu/pallas_ldu.py:307",
    "matvec": "dojo_tpu/pallas_ldu.py:324",
}


def kernel_rows(ds, blocks, fact, rhs, x, mag, errors, model, suffix="", reps=20, plain_reps=3):
    """One kernels-line row per kernel of the schedule's width class (or of
    the variants "packed" and "lane", csrc/ldu_lane.cu, where the lane does not fit a
    CTA), named <kernel><class><suffix>: times at these inputs and for one lane
    (factorize, solve), the plain versions' and the BSR product's times
    (matvec), the bound (work(): W-wide blocks) and the bound at real
    widths (work_real(): what these inputs need), and the shared memory
    each kernel was launched with."""
    from dojo_tpu_torch import ldu, ldu_cuda as L

    sched = ds.sched
    B = blocks.shape[0]
    lib_call, y_lib = bsr_matvec(ds, blocks, x)
    y_p = ldu.matvec(ds.plan, blocks, x)
    err_lib = (y_lib - y_p).abs().max().item()
    check(bool(((y_lib - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"BSR yardstick disagrees with the plain matvec by {err_lib}")
    need = work(sched, B, blocks.element_size())
    need_real = work_real(sched, B, blocks.element_size())
    calls = {
        "factorize": (lambda: L.factorize(ds, blocks), lambda: ldu.factorize(ds.plan, blocks), None),
        "solve": (lambda: L.solve(ds, fact, rhs), lambda: ldu.solve(ds.plan, fact, rhs), None),
        "matvec": (lambda: L.matvec(ds, blocks, x), lambda: ldu.matvec(ds.plan, blocks, x),
                   lib_call),
    }
    # one lane alone: the time of a lane's dependency chain (a full batch
    # adds the traffic of all lanes and the lanes that share an SM)
    b1, r1 = blocks[:1].contiguous(), rhs[:1].contiguous()
    f1 = L.factorize(ds, b1)
    lane_ms = {"factorize": time_ms(lambda: L.factorize(ds, b1), reps),
               "solve": time_ms(lambda: L.solve(ds, f1, r1), reps)}
    rows = {}
    for k, (name, (kern, plain, lib)) in enumerate(calls.items()):
        cls = L.variant(sched, name, blocks.dtype, ds.buf.numel())
        ms = time_ms(kern, reps)
        # the cap the runtime holds for the kernel, which its launcher sets
        # to the bytes of each launch
        elem = blocks.element_size()
        smem = (L.lane_library(elem, name).ldu_lane_kernel_smem(k, elem)
                if cls in L.LANE_VARIANTS
                else L.library(elem=elem).ldu_kernel_smem(k, elem, sched.width))
        check(smem > 0, f"{name}: cannot read the kernel's shared-memory attribute")
        bound_ms, bound_by = bound(*need[name])
        real_ms, real_by = bound(*need_real[name])
        rows[name + CLASS_NAME[cls] + suffix] = dict(
            name=name + CLASS_NAME[cls] + suffix, route="cuda",
            source="dojo_tpu_torch/csrc/" + ("ldu_lane.cu" if cls in L.LANE_VARIANTS
                                             else "ldu.cu"),
            replaces=REPLACES[name], launches=0, max_abs_err=errors[name], ms=ms,
            plain_ms=time_ms(plain, plain_reps, spin=False), bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=time_ms(lib, reps) if lib is not None else None,
            ms_one_lane=lane_ms.get(name), bound_ms_real=real_ms, bound_by_real=real_by,
            class_row=name + CLASS_NAME[cls],
            smem_bytes=smem, width_class=cls, model=model, W=sched.width, B=B,
            bytes=need[name][0], flops=need[name][1], bytes_real=need_real[name][0],
            flops_real=need_real[name][1],
        )
    return rows


def lu_swap_phase(lanes=16, kinds=("random", "dup", "comb"), device="cuda"):
    """Each width class's factorize kernel (on CLASS_MODEL's schedule) on
    swap_blocks, each node's block factored as made, against the plain
    block LU: every LU and PS bitwise equal, and no smallest pivot at the
    floor where the plain one's is not (the dup blocks' pivots cancel to
    exactly 0 without the arithmetic swap)."""
    import torch

    from dojo_tpu_torch import ldu_cuda as L, models
    from dojo_tpu_torch.graph import build_schedule

    out = {}
    for cls, name in CLASS_MODEL.items():
        kw = {"timestep": MPC_DT} if name == "quadruped" else {}
        sched = build_schedule(models.get_mechanism(name, device="cpu", **kw).topo)
        ds = L.DeviceSchedule(sched, device)
        for kind in kinds:
            res = lu_vs_plain(sched, *L.factorize(ds, isolated_blocks(sched, kind, 0, lanes,
                                                                      device)))
            out[f"{cls}_{kind}"] = res
            check(res["differ"] == 0 and res["floored"] == 0,
                  f"{name} factorize on {kind} blocks: {res} (bitwise, none floored)")
    torch.cuda.synchronize()
    return out


def plant_knots(topo, params, plant_step, y0, most=PLANT_KNOTS):
    """tests/test_torch_linearize_f32_ref.py's knots: PLANT_LANES perturbed
    standing lanes (minimal state y0) with random inputs (numpy seed 0),
    stepped by plant_step (the plant's options) on y0's device.  Returns
    (the lanes that converged with μ at 1e-5, [y, u, w, μ] at the first
    `most` of them)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    py = np.repeat(y0.cpu().numpy()[None], PLANT_LANES, 0)
    py[:, :2] += rng.normal(scale=0.01, size=(PLANT_LANES, 2))
    py[:, 6:9] += rng.normal(scale=0.02, size=(PLANT_LANES, 3))
    pu = rng.normal(scale=0.5, size=(PLANT_LANES, topo.input_dim)).astype(np.float32)
    p_y, p_u = torch.as_tensor(py, device=y0.device), torch.as_tensor(pu, device=y0.device)
    _, p_w, p_mu, p_ok = plant_step(params, p_y, p_u)
    conv = (p_ok & ((p_mu - 1e-5).abs() < 1e-9)).nonzero().flatten()
    return conv, [a[conv[:most]] for a in (p_y, p_u, p_w, p_mu)]


def mpc_phase(H=MPC_H, B=MPC_B, device="cuda"):
    """One trot-MPC control step on the card (bench.py phase "mpc"), then
    the shared-factorization kernels and the float32 linearize against
    their plain versions.  Returns (the kernel launches of the control
    step per kernels-line row, the kernels-line rows of the shared-factor
    solve and matvec)."""
    import contextlib

    import numpy as np
    import torch

    from dojo_tpu_torch import ldu, ldu_cuda as L, models
    from dojo_tpu_torch.blocks import make_assembler
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_maximal, to_minimal
    from dojo_tpu_torch.graph import build_schedule
    from dojo_tpu_torch.mpc import Trace, actuated_indices, make_trot_rt, trot_gains
    from dojo_tpu_torch.mpc import trot_spring_params
    from dojo_tpu_torch.residual import make_context, pad_inputs

    class KernelTrace(Trace):
        """Trace that also counts each part's kernel launches."""

        @contextlib.contextmanager
        def part(self, name, device):
            before = launch_counts()
            with super().part(name, device) as counts:
                yield counts
            after = launch_counts()
            prev = counts.get("launches", {})
            counts["launches"] = {k: prev.get(k, 0) + after[k] - before[k] for k in after}

    f32, dev = torch.float32, torch.device(device)
    mech = models.get_mechanism("quadruped", timestep=MPC_DT, device=dev).cast(f32)
    topo = mech.topo
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(topo, mech.params, tensor_map(lambda a: a[None], s0))[0]
    ny = topo.minimal_dim
    rt_opts = SolverOptions(rtol=1e-4, btol=1e-3, max_iter=16, rescue=True)
    plant_opts = SolverOptions(**PLANT_OPTS)
    mpc, ref_fn, _ = make_trot_rt(mech, horizon=H, opts=rt_opts, dt=MPC_DT, alphas=ALPHAS,
                                  iterations=1, device=dev)
    gains = trot_gains(mech, joint_w=1.0, reg=10.0, du_max=1e9, kff=0.0, dtype=f32)
    gains = gains._replace(Qd=gains.Qd.expand(H + 1, ny).contiguous())
    params = trot_spring_params(mech, springs=40.0, dampers=4.0)
    plant_step, plant_lin, plant_seed = make_rollout_linearize_minimal(topo, plant_opts,
                                                                       device=dev)
    act = torch.as_tensor(actuated_indices(mech), dtype=torch.long, device=dev)
    rng = np.random.default_rng(0)
    pert = np.zeros((B, ny), dtype=np.float32)
    pert[:, :2] = rng.normal(scale=0.01, size=(B, 2))  # base xy
    pert[:, 6:9] = rng.normal(scale=0.02, size=(B, 3))  # base velocity
    ys = y0[None] + torch.as_tensor(pert, device=dev)
    dus_warm = torch.zeros(B, H, 12, dtype=f32, device=dev)
    goals = ref_fn(0.0)
    w_plant = plant_seed(params, ys)

    # ---- the control step (bench.py control_step) ---------------------------
    trace = KernelTrace()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launches()
    t = time.perf_counter()
    u0, dus_next, c, okf = mpc(params, ys, dus_warm, goals, *gains, trace=trace)
    with trace.part("plant", dev) as plant_counts:
        u_full = torch.zeros(B, topo.input_dim, dtype=f32, device=dev).index_copy(1, act, u0)
        ys2, w2, mu2, ok = plant_step(params, ys, u_full, w_plant, stats=plant_counts)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launches = launch_counts()
    launches_cls = class_launch_counts()
    launches_rows = row_launch_counts()
    peak = torch.cuda.max_memory_allocated()

    def plain(v):
        if isinstance(v, torch.Tensor):
            return v.tolist()
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    parts = {}
    for name, counts in trace.counts.items():
        entry = {"ms": trace.ms[name], **plain({k: v for k, v in counts.items() if k != "cost"})}
        if "lanes" in counts:
            entry["iterations_per_lane"] = float(counts["iterations"]) / counts["lanes"]
        parts[name] = entry
    check(bool(torch.isfinite(u0).all()), "mpc: non-finite u0")
    plant_success = ok.float().mean().item()
    emit("mpc", B=B, H=H, dt=MPC_DT, alphas=list(ALPHAS), dtype="float32",
         **({"reduced": {"H": H}} if H != MPC_H else {}),
         control_step_ms=step_ms, parts=parts, okf=okf.mean().item(),
         cost_before=plain(trace.counts["rollout"]["cost"]),
         cost_after=plain(trace.counts["forward"]["cost"]),
         plant_success=plant_success, launches=launches, peak_memory_bytes=peak,
         u0_abs_max=u0.abs().max().item())
    check(plant_success >= 0.9, f"mpc: plant-step success {plant_success} < 0.9")
    for n, c in launches_cls.items():
        check(c["w16"] > 0, f"kernel {n} was not launched in the control step")
        check(sum(c.values()) == c["w16"], "mpc: a kernel of another class than w16 ran")
    for n in ("solve_shared", "matvec_shared"):  # the linearize's 54 columns a knot
        check(launches_rows[n] > 0, f"kernel {n} was not launched in the control step")

    # ---- shared factorization at the rollout's knots: B·H knots x 54 columns
    sched = build_schedule(topo)
    ds = L.DeviceSchedule(sched, dev)
    r_ys, r_us, r_ws, r_mus = trace.linearized_at
    knots, C = B * H, topo.minimal_dim + topo.input_dim
    flat = lambda a: a.reshape(knots, *a.shape[2:])
    k_y, k_w, k_mu = flat(r_ys[:, :-1]), flat(r_ws), flat(r_mus)
    k_u = torch.zeros(knots, topo.input_dim, dtype=f32, device=dev).index_copy(1, act, flat(r_us))
    kctx = make_context(topo, to_maximal(topo, params, k_y), params, pad_inputs(topo, k_u))
    blocks = make_assembler(topo, sched, dev)(k_w, kctx, params, k_mu).contiguous()
    fact = L.factorize(ds, blocks)
    gen = torch.Generator(device="cpu").manual_seed(1)
    flat_rhs = torch.randn((knots * C, topo.dim), generator=gen, dtype=f32).to(dev)
    rhs = L.flat_to_nodes(ds.plan, flat_rhs).contiguous()
    # the shared-factor solve alone (unrefined) against the plain float32
    # solve, and against the plain float64 solve on the same factors for
    # the float32 solves' own error.  At these knots a float32 solve errs
    # by ~1e-3 of a column's scale (median; up to ~0.1) against float64,
    # and the kernel and the plain solve round differently (the kernel's
    # FMAs), so they differ by as much: the kernel's per-column errors are
    # held to the plain float32 solve's at the 50th, 90th and 99th
    # percentile and the largest, within 2x.  On the quadruped's KKT at
    # μ = 1e-3 at the same shape, where a float32 solve errs by ~3e-5 of a
    # column's scale, the kernel is held to the plain solve directly, to
    # 2e-5 of scale, as tests/test_torch_cuda.py does at B=5.
    x_k0 = L.solve(ds, fact, rhs, C)
    x_p0 = ldu.solve(ds.plan, fact, rhs, C)
    err_solve0 = (x_k0 - x_p0).abs().max().item()
    x_64 = ldu.solve(ds.plan, [f.double() for f in fact], rhs.double(), C)
    col_scale = x_64.abs().flatten(1).amax(1)
    pct = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=dev)
    col_err = lambda x: ((x.double() - x_64).abs().flatten(1).amax(1) / col_scale).quantile(pct)
    q_kernel, q_plain = col_err(x_k0).tolist(), col_err(x_p0).tolist()
    del x_64, x_k0
    _, _, kkt, _ = model_kkt(mech, models.initialize(mech, "quadruped"), knots, dev)
    kkt_fact = L.factorize(ds, kkt)
    x_kkt = ldu.solve(ds.plan, kkt_fact, rhs, C)
    scale_kkt = x_kkt.abs().max().item()
    err_kkt = (L.solve(ds, kkt_fact, rhs, C) - x_kkt).abs().max().item()
    del kkt, kkt_fact, x_kkt
    emit("mpc_shared_solve", vs_plain=err_solve0, percentiles=pct.tolist(),
         col_err_kernel=q_kernel, col_err_plain=q_plain, kkt_vs_plain=err_kkt,
         kkt_scale=scale_kkt)
    check(all(a <= 2 * b for a, b in zip(q_kernel, q_plain)),
          f"shared solve: per-column errors {q_kernel} over 2x the plain float32 {q_plain}")
    check(err_kkt / scale_kkt < 2e-5,
          f"shared solve on the KKT at μ=1e-3: {err_kkt} of scale {scale_kkt} (2e-5)")
    x_k = L.solve_refine(ds, blocks, fact, rhs, 1, rhs_per_fact=C)
    x_p = x_p0 + ldu.solve(ds.plan, fact, rhs - ldu.matvec(ds.plan, blocks, x_p0, C), C)
    scale = x_p.abs().max().item()
    err_solve = (x_k - x_p).abs().max().item()
    y_k = L.matvec(ds, blocks, x_k, C)
    y_p = ldu.matvec(ds.plan, blocks, x_k, C)
    mag = ldu.matvec(ds.plan, blocks.abs(), x_k.abs(), C)
    err_mv = (y_k - y_p).abs().max().item()
    lib_call, y_lib = bsr_matvec(ds, blocks, x_k, C)
    err_lib = (y_lib - y_p).abs().max().item()
    check(bool(((y_lib - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"BSR yardstick disagrees with the plain shared matvec by {err_lib}")
    need = work(sched, knots, 4, C)
    shared = {}
    for name, kern, pl, lib in (
        ("solve", lambda: L.solve(ds, fact, rhs, C), lambda: ldu.solve(ds.plan, fact, rhs, C),
         None),
        ("matvec", lambda: L.matvec(ds, blocks, x_k, C),
         lambda: ldu.matvec(ds.plan, blocks, x_k, C), lib_call),
    ):
        bound_ms, bound_by = bound(*need[name])
        ms = time_ms(kern, 5)
        # the cap the launcher set for this shape (kernel 3: the shared-factor
        # solve; 4: the matvec at k > 1)
        kc = ds.chunk("solve_shared" if name == "solve" else "matvec", f32, C)
        smem = L.library(elem=4).ldu_kernel_smem(3 if name == "solve" else 4, 4, sched.width)
        shared[name + "_shared"] = dict(
            name=name + "_shared", route="cuda", source="dojo_tpu_torch/csrc/ldu.cu",
            replaces=REPLACES[name], launches=0, max_abs_err=err_solve0 if name == "solve"
            else err_mv, ms=ms, plain_ms=time_ms(pl, 2, spin=False), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=time_ms(lib, 5) if lib is not None else None,
            smem_bytes=smem,
            width_class="w16", W=sched.width, B=knots, k=C, bytes=need[name][0],
            flops=need[name][1], kc=kc)
    emit("mpc_shared_factor", knots=knots, rhs_per_fact=C, lanes=knots * C, solve_scale=scale,
         solve_refined_err=err_solve, kernels=shared)
    check(err_solve / scale < 2e-5,
          f"shared solve, refined once: {err_solve} of scale {scale} (2e-5)")
    check(bool(((y_k - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"shared matvec: max error {err_mv} exceeds 1e-5·Σ|E||x|")

    # ---- float32 linearize on the card vs plain float64 on the CPU, at 4 of
    # the rollout's knots (4 scenarios, 4 knots along the horizon)
    lanes = torch.arange(4, device=dev) * B // 4
    steps = torch.arange(4, device=dev) * H // 4
    pick = lambda a: a[lanes, steps]
    l_y, l_w, l_mu = pick(r_ys), pick(r_ws), pick(r_mus)
    l_u = torch.zeros(4, topo.input_dim, dtype=f32, device=dev).index_copy(1, act, pick(r_us))
    A32, B32 = plant_lin(params, l_y, l_u, l_w, l_mu)
    mech64 = models.get_mechanism("quadruped", timestep=MPC_DT, device="cpu")
    p64 = trot_spring_params(mech64, springs=40.0, dampers=4.0)
    _, lin64, _ = make_rollout_linearize_minimal(mech64.topo, plant_opts, device="cpu")
    A64, B64 = lin64(p64, *(a.cpu().double() for a in (l_y, l_u, l_w, l_mu)))
    scale_a = max(1.0, A64.abs().max().item())
    err_lin = max((A32.cpu().double() - A64).abs().max().item(),
                  (B32.cpu().double() - B64).abs().max().item()) / scale_a
    emit("mpc_linearize", scenarios=lanes.tolist(), knots=steps.tolist(), rel_err=err_lin,
         tol=LIN_TOL, A_inf=scale_a)
    check(err_lin < LIN_TOL, f"float32 linearize: {err_lin} of max(1, |A|) (tol {LIN_TOL})")

    # ---- float32 linearize at the plant's knots (μ = 1e-5): the card against
    # plain float64 on the CPU.  The fault this guards (a pivot cancelled to
    # exactly 0 and floored) is checked per knot: no smallest pivot at the
    # floor.  The errors are held as a whole: their median within 10x the
    # plain float32 CPU median, or LIN_TOL.  A knot's error alone is
    # rounding noise on a pivot of ~5e-8: at most knots it moves by more
    # than 10x, and up to ~10^3, when w moves by one ulp
    # (tests/test_torch_linearize_f32_ref.py), so knots where the card's
    # exceeds 10x the CPU's are reported, not gated.
    t = time.perf_counter()
    conv, kargs = plant_knots(topo, params, plant_step, y0, PLANT_KNOTS)
    check(len(conv) >= 8, f"plant knots: {len(conv)} of {PLANT_LANES} lanes converged at μ=1e-5")
    knot = conv[:PLANT_KNOTS]
    A32, B32 = plant_lin(params, *kargs)
    kctx = make_context(topo, to_maximal(topo, params, kargs[0]), params, pad_inputs(topo, kargs[1]))
    kblocks = make_assembler(topo, sched, dev)(kargs[2], kctx, params, kargs[3]).contiguous()
    min_piv = lambda LU: LU.diagonal(dim1=-2, dim2=-1).abs().flatten(1).amin(1).cpu()
    piv_card = min_piv(L.factorize(ds, kblocks)[1])
    piv_cpu = min_piv(ldu.factorize(ldu.LduPlan(sched, "cpu"), kblocks.cpu())[1])
    A64, B64 = lin64(p64, *(a.cpu().double() for a in kargs))
    mech32 = models.get_mechanism("quadruped", timestep=MPC_DT, device="cpu").cast(f32)
    _, lin32, _ = make_rollout_linearize_minimal(mech32.topo, plant_opts, device="cpu")
    A32c, B32c = lin32(trot_spring_params(mech32, springs=40.0, dampers=4.0),
                       *(a.cpu() for a in kargs))
    scale_k = A64.abs().amax(dim=(1, 2)).clamp_min(1.0)
    rel = lambda A, B: (torch.maximum((A.cpu().double() - A64).abs().amax(dim=(1, 2)),
                                      (B.cpu().double() - B64).abs().amax(dim=(1, 2)))
                        / scale_k)
    e_card, e_cpu = rel(A32, B32), rel(A32c, B32c)
    med_card, med_cpu = e_card.median().item(), e_cpu.median().item()
    over = [i for i in range(len(knot)) if e_card[i] > max(10 * e_cpu[i], LIN_TOL)]
    floored = [i for i in range(len(knot)) if piv_card[i] <= ldu.pivot_floor(f32)]
    emit("mpc_linearize_plant", lanes=knot.tolist(), converged=len(conv),
         rel_err=e_card.tolist(), rel_err_cpu_f32=e_cpu.tolist(),
         min_pivot=piv_card.tolist(), min_pivot_cpu_f32=piv_cpu.tolist(),
         median=med_card, median_cpu_f32=med_cpu, tol=max(10 * med_cpu, LIN_TOL),
         knots_over_10x_cpu=over, seconds=time.perf_counter() - t)
    check(not floored, f"float32 linearize at plant knots {floored}: smallest pivot at the floor")
    check(med_card <= max(10 * med_cpu, LIN_TOL),
          f"float32 linearize at plant knots: median error {med_card} of max(1, |A|), "
          f"plain float32 {med_cpu} (tol 10x, or {LIN_TOL})")
    return launches_rows, shared


def zoo_state(name, device):
    """A zoo model's initial state in float32: made in float64 on the CPU and
    rounded once.  bench_zoo initializes in float32 on its device, which
    rounds differently on each device and in each package; at rtol=1e-6 in
    float32 whether a step converges turns on those last bits, so the card's
    lanes and the reference (tests/test_torch_zoo_f32_ref.py) start from
    these same bits."""
    import torch

    from dojo_tpu_torch import models
    from dojo_tpu_torch.core import tensor_map

    state = models.initialize(models.get_mechanism(name, device="cpu"), name)
    return tensor_map(lambda a: a.to(torch.float32).to(device), state)


def zoo_phase(K=ZOO_K, B=ZOO_B, names=ZOO_MODELS, device="cuda"):
    """bench_zoo.py's cross-zoo step on the card: per model, the model's
    KKT through its width class's kernels against the plain versions (which
    also warms the kernels up), then K timed steps, checked for finite
    states and success; then the KKTs of ZOO_KKT_EXTRA through their
    class's kernels against the plain versions (phase zoo_kkt).  Returns
    (launches of the timed steps per kernels-line row, summed over the
    models; kernels-line rows of the w17_32 and w33_72 classes, timed on
    CLASS_MODEL's and ROW_MODELS' KKTs, each with the launches of its
    class's kernels on its own model's timed steps, launches_zoo_model)."""
    import torch

    from dojo_tpu_torch import ldu_cuda as L, models
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.simulate import make_step

    dev = torch.device(device)
    opts = SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30)
    total = dict.fromkeys(row_launch_counts(), 0)
    rows = {}
    for name in names:
        t0 = time.perf_counter()
        mech = models.get_mechanism(name, device=dev).cast(torch.float32)
        topo, params = mech.topo, mech.params
        state = zoo_state(name, dev)
        h = float(params.timestep)
        step = make_step(topo, opts, device=dev)
        bstate = tensor_map(lambda a: a.expand(B, *a.shape).contiguous(), state)

        # the model's KKT through its class's kernels, against the plain versions
        sched, ds, blocks, rhs = model_kkt(mech, state, B, dev, step.init_w)
        cls = L.width_class(sched.width)
        errors, fact_k, x_k, mag = check_kernels(ds, blocks, rhs, f"zoo {name}")
        need = work(sched, B, 4)
        kms = {"factorize": time_ms(lambda: L.factorize(ds, blocks), 10),
               "solve": time_ms(lambda: L.solve(ds, fact_k, rhs), 10),
               "matvec": time_ms(lambda: L.matvec(ds, blocks, x_k), 10)}
        kernels = {n: dict(ms=kms[n], bound_ms=bound(*need[n])[0], max_abs_err=errors[n])
                   for n in kms}
        mine = {}
        if CLASS_MODEL[cls] == name and cls != "w16":
            mine = kernel_rows(ds, blocks, fact_k, rhs, x_k, mag, errors, name)
        elif ROW_MODELS.get(name) == cls:
            mine = kernel_rows(ds, blocks, fact_k, rhs, x_k, mag, errors, name, "_" + name)
        rows.update(mine)

        # K timed steps, as bench_zoo steps: u=None, no warm start
        lanes = ZOO_FAILS_B if name in ZOO_REFERENCE_FAILS else B
        if lanes < B:
            bstate = tensor_map(lambda a: a[:lanes].contiguous(), bstate)
        L.reset_launches()
        st, oks, its, rescued = bstate, [], [], 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(K):
            st, info = step(params, st)
            oks.append(info.success)
            its.append(info.iterations)
            rescued += int(info.rescued.sum())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = class_launch_counts()
        own = row_launch_counts()
        for n, c in own.items():
            total[n] += c
        for row in mine.values():
            row["launches_zoo_model"] = own[row["class_row"]]
        finite = all(bool(torch.isfinite(f).all()) for f in (st.x, st.q, st.v, st.w))
        success = torch.stack(oks).float().mean().item()
        emit("zoo", model=name, W=sched.width, width_class=cls, dim=topo.dim, B=B, K=K,
             n_reference=max(2, int(round(1.0 / h))), h=h, lanes_stepped=lanes,
             reduced={"steps": K, **({"lanes_stepped": lanes} if lanes < B else {})},
             dtype="float32", steps_per_s=lanes * K / dt,
             sim_seconds_per_s=lanes * K * h / dt,
             success=success, mean_iters=torch.stack(its).float().mean().item(),
             rescued_lanes=rescued,
             reference_fails_too=name in ZOO_REFERENCE_FAILS,
             launches={n: launches[n][cls] for n in launches}, kernels=kernels,
             lu_identity=errors["lu_identity"], relres=errors["relres"],
             limits=errors["limits"], seconds=time.perf_counter() - t0)
        check(finite, f"zoo {name}: non-finite state after the timed steps")
        for n, c in launches.items():
            check(c[cls] > 0, f"zoo {name}: kernel {n} of class {cls} was not launched")
            check(sum(c.values()) == c[cls], f"zoo {name}: a kernel of another class ran")
        if name not in ZOO_REFERENCE_FAILS:
            check(success >= 0.9, f"zoo {name}: success {success} < 0.9")
    for name, dt in ZOO_KKT_EXTRA:
        dtype = getattr(torch, dt)
        mech = models.get_mechanism(name, device=dev).cast(dtype)
        sched, ds, blocks, rhs = model_kkt(mech, models.initialize(mech, name), B, dev)
        cls = L.width_class(sched.width)
        L.reset_launches()
        errors, fact_k, x_k, _ = check_kernels(ds, blocks, rhs, f"zoo {name} {dt}")
        launches = class_launch_counts()
        for n, c in launches.items():
            check(c[cls] > 0 and sum(c.values()) == c[cls],
                  f"zoo {name} {dt}: kernel {n} of class {cls} did not run alone: {c}")
        need, need_real = work(sched, B, blocks.element_size()), work_real(sched, B,
                                                                         blocks.element_size())
        calls = {"factorize": lambda: L.factorize(ds, blocks),
                 "solve": lambda: L.solve(ds, fact_k, rhs),
                 "matvec": lambda: L.matvec(ds, blocks, x_k)}
        emit("zoo_kkt", model=name, dtype=dt, W=sched.width, width_class=cls, B=B,
             lu_blocks_bitwise=errors["lu_blocks"], lu_identity=errors["lu_identity"],
             relres=errors["relres"], solve_scale=errors["solve_scale"],
             limits=errors["limits"],
             kernels={n: dict(ms=time_ms(fn, 10), bound_ms=bound(*need[n], dt)[0],
                              bound_ms_real=bound(*need_real[n], dt)[0],
                              max_abs_err=errors[n]) for n, fn in calls.items()})
    return total, rows


def diff_phase(B=DIFF_B, T=DIFF_T, device="cuda"):
    """The differentiable step on the card (gradients.make_diff_step*): the
    quadruped at bench.py's options in float32, B lanes from its initial
    state, each with its own inputs (DIFF_U_SCALE·N(0, 1) per actuated
    coordinate, seeded), T steps of make_diff_step_minimal and the loss
    mean over lanes of Σ y_t² after step t.  Checks (a) reverse mode at
    t = T: every lane of every step's forward solve converged (the dense
    rescue included; the rescued lanes are counted), finite grads on every
    step's inputs, contact_friction and mass, each step's inputs a nonzero
    gradient; (b) forward mode at t = DIFF_T_FWD: ⟨∇L, d⟩ by
    torch.func.jvp along a seeded direction d in (u, contact_friction)
    against the reverse mode of the same loss (taken on (a)'s graph),
    relative to Σ|∂L/∂θᵢ dᵢ|, float32 (and float64 on DIFF_B64 lanes over
    DIFF_T64 steps); (e) solve.traced against solve on
    step 1's solve; (c) minimal_jacobians (dense LU) against linearize (the
    LDU kernels' k = 54 shared-factor solve and one refine sweep) at (e)'s
    solution, on all of step 1's lanes, those the dense rescue finished and
    the others each held to the limit; (d) the sphere's ∂(next state)/∂v0
    by jvp against central
    differences, float64.
    Returns the kernels' launches in the phase per kernels-line row."""
    import dataclasses

    import torch

    from dojo_tpu_torch import ldu_cuda as L, models
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.gradients import (make_diff_step, make_diff_step_minimal,
                                          make_rollout_linearize_minimal, minimal_jacobians,
                                          to_maximal, to_minimal)
    from dojo_tpu_torch.mpc import actuated_indices
    from dojo_tpu_torch.residual import make_context, pad_inputs
    from dojo_tpu_torch.solver import make_solver

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    opts = SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30)
    seconds, errors = {}, {}
    L.reset_launches()
    clock = [time.perf_counter()]

    def lap(name):
        sync()
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now
        emit("diff_part", part=name, seconds=seconds[name])

    def case(dtype, lanes, T):
        """(mech, y0 (lanes, ny), inputs (T, lanes, nu), direction of (b) in
        the inputs and in contact_friction, loss of (inputs, friction, mass))."""
        mech = models.get_mechanism("quadruped", timestep=0.05, device=dev).cast(dtype)
        topo, params = mech.topo, mech.params
        s0 = tensor_map(lambda a: a[None], models.initialize(mech, "quadruped"))
        y0 = to_minimal(topo, params, s0).expand(lanes, -1).contiguous()
        gen = torch.Generator().manual_seed(0)
        act = torch.as_tensor(actuated_indices(mech), dtype=torch.long)
        draw = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64)
        us = torch.zeros(T, lanes, topo.input_dim, dtype=torch.float64)
        us[..., act] = DIFF_U_SCALE * draw(T, lanes, len(act))
        du = torch.zeros_like(us)
        du[..., act] = draw(T, lanes, len(act))
        dfric = draw(topo.nc)
        to = lambda a: a.to(dtype).to(dev)
        step = make_diff_step_minimal(topo, opts, device=dev)

        def losses(u, fric, mass, stats, steps=T):
            """The loss after each of the first `steps` steps."""
            p = dataclasses.replace(params, contact_friction=fric, mass=mass)
            y, out = y0, []
            for t in range(steps):
                y = step(p, y, u[t], stats[t])
                out.append((y * y).sum(-1).mean())
            return out

        return mech, y0, to(us), (to(du), to(dfric)), losses

    def solves(stats, part):
        """The forward solves' counts per step, each step's success share
        at least DIFF_SUCCESS."""
        for t, st in enumerate(stats):
            check(st["failed"] <= (1 - DIFF_SUCCESS) * st["lanes"],
                  f"diff {part}: {st['failed']} of {st['lanes']} lanes of step {t + 1}'s "
                  f"forward solve did not converge")
        return [dict(failed=st["failed"], rescued=st["rescued"],
                     iterations=st["iterations"] / st["lanes"]) for st in stats]

    def reverse_forward(dtype, lanes, T, T_fwd, what):
        """(a) on `lanes` lanes over T steps and (b) over the first T_fwd;
        returns (mech, y0, inputs)."""
        mech, y0, us, (du, dfric), losses = case(dtype, lanes, T)
        u = us.clone().requires_grad_()
        fric = mech.params.contact_friction.clone().requires_grad_()
        mass = mech.params.mass.clone().requires_grad_()
        stats_a, stats_b = [{} for _ in range(T)], [{} for _ in range(T_fwd)]
        values = losses(u, fric, mass, stats_a)
        value, value_fwd = values[-1], values[T_fwd - 1]
        # the reverse mode of (b)'s loss, on (a)'s graph
        g_fwd = torch.autograd.grad(value_fwd, (u, fric), retain_graph=True)
        value.backward()
        grads = {"u": u.grad, "contact_friction": fric.grad, "mass": mass.grad}
        lap("a" + what)
        errors["a" + what] = dict(solves=solves(stats_a, "a" + what))
        for name, g in grads.items():
            check(bool(torch.isfinite(g).all()), f"diff {what}: non-finite grad of {name}")
        step_norm = u.grad.flatten(1).norm(dim=1)
        check(bool((step_norm > 0).all()), f"diff {what}: a step's inputs got no gradient")
        _, fwd = torch.func.jvp(
            lambda u_, f_: losses(u_, f_, mech.params.mass, stats_b, T_fwd)[-1],
            (us[:T_fwd], mech.params.contact_friction), (du[:T_fwd], dfric))
        terms = torch.cat([(g_fwd[0][:T_fwd] * du[:T_fwd]).flatten(),
                           g_fwd[1] * dfric]).double()
        rev = terms.sum().item()
        rel = abs(fwd.item() - rev) / terms.abs().sum().item()
        errors["b" + what] = dict(steps=T_fwd, forward=fwd.item(), reverse=rev, rel_err=rel,
                                  tol=DIFF_FWD_TOL[str(dtype)], loss=value_fwd.item(),
                                  grad_norm={k: g.norm().item() for k, g in grads.items()},
                                  step_grad_norm=step_norm.tolist(),
                                  solves=solves(stats_b, "b" + what))
        lap("b" + what)
        check(rel < DIFF_FWD_TOL[str(dtype)],
              f"diff {what}: forward {fwd.item()} against reverse {rev}: {rel} relative "
              f"(tol {DIFF_FWD_TOL[str(dtype)]})")
        return mech, y0, us

    mech, y0, us = reverse_forward(torch.float32, B, T, min(T, DIFF_T_FWD), "")
    reverse_forward(torch.float64, DIFF_B64, DIFF_T64, DIFF_T64, "64")
    topo, params = mech.topo, mech.params

    # (e) solve.traced against solve on step 1's solve
    init_w, solve, _ = make_solver(topo, device=dev)
    state = to_maximal(topo, params, y0)
    ctx = make_context(topo, state, params, pad_inputs(topo, us[0]))
    w0 = init_w(state.v, state.w, params)
    res = solve(w0, ctx, params, opts)
    res_t, trace = solve.traced(w0, ctx, params, opts)
    keep = ~res.rescued
    same_iters = bool((res_t.iterations[keep] == res.iterations[keep]).all())
    w_scale = res.w[keep].abs().max().item()
    err_w = (res_t.w[keep] - res.w[keep]).abs().max().item() / w_scale
    valid = trace["valid"]
    med = lambda k: [trace[k][i][valid[i]].median().item() if valid[i].any() else None
                     for i in range(opts.max_iter)]
    errors["e"] = dict(rescued=int(res.rescued.sum()), same_iterations=same_iters,
                       w_rel_err=err_w, tol=DIFF_TRACE_TOL,
                       iterations=res.iterations.float().mean().item())
    lap("e")
    print(json.dumps({"phase": "diff_trace", "median_rvio": med("rvio"),
                      "median_bvio": med("bvio"), "median_mu": med("mu")}), flush=True)
    check(same_iters, "diff (e): solve.traced's iterations differ from solve's")
    check(err_w < DIFF_TRACE_TOL, f"diff (e): solve.traced's w {err_w} of scale from solve's "
          f"(tol {DIFF_TRACE_TOL})")

    # (c) the dense IFT against the LDU kernels' IFT at step 1:
    # minimal_jacobians solves the same B lanes as (e)'s solve, and
    # linearize takes that solve's (w, μ); held on every lane it converged,
    # the rescued lanes apart
    ok = res.success
    A_d, B_d = minimal_jacobians(topo, opts, device=dev)(params, y0, us[0])
    _, linearize, _ = make_rollout_linearize_minimal(topo, opts, device=dev)
    A_k, B_k = linearize(params, y0, us[0], res.w, res.mu)
    scale = max(1.0, A_d[ok].abs().max().item())
    lane_err = torch.maximum((A_k - A_d).abs().flatten(1).max(1).values,
                             (B_k - B_d).abs().flatten(1).max(1).values) / scale
    worst = lambda m: lane_err[m].max().item() if bool(m.any()) else None
    rel, rel_rescued = worst(ok & ~res.rescued), worst(res.rescued)
    errors["c"] = dict(lanes=B, failed=int((~ok).sum()), rescued=int(res.rescued.sum()),
                       rel_err=rel, rel_err_rescued=rel_rescued, tol=DIFF_JAC_TOL, A_inf=scale)
    lap("c")
    check(ok.float().mean().item() >= DIFF_SUCCESS,
          f"diff (c): {int((~ok).sum())} of {B} lanes of step 1's solve did not converge")
    check(bool(torch.isfinite(lane_err[ok]).all()) and lane_err[ok].max().item() < DIFF_JAC_TOL,
          f"diff (c): minimal_jacobians against linearize {rel} (lanes not rescued), "
          f"{rel_rescued} (rescued) of max(1, |A|) (tol {DIFF_JAC_TOL})")

    # (d) the sphere through contact, float64: jvp in v0 against central differences
    # one solve of 3 x DIFF_FD_LANES lanes: v0 (the tangent's), v0 + ε and
    # v0 − ε (the lanes are independent: three solves took 130 s, PR 12)
    sph = models.get_mechanism("sphere", timestep=0.01, device=dev)
    s_one = models.initialize(sph, "sphere", position=(0, 0, 0.52), velocity=(1, 0, 0))
    n = DIFF_FD_LANES
    s_lanes = tensor_map(lambda a: a.expand(3 * n, *a.shape).contiguous(), s_one)
    sph_opts = SolverOptions(rtol=1e-8, btol=1e-8, max_iter=DIFF_FD_ITERS)
    sph_step = make_diff_step(sph.topo, sph_opts, device=dev)
    v0 = torch.linspace(0.5, 2.0, n, dtype=torch.float64, device=dev)

    def out(v):
        vel = torch.cat([v[:, None, None], s_lanes.v[..., 1:]], dim=-1)
        return sph_step(sph.params, dataclasses.replace(s_lanes, v=vel)).pack()

    v_all = torch.cat([v0, v0 + DIFF_FD_EPS, v0 - DIFF_FD_EPS])
    z, dz = torch.func.jvp(out, (v_all,), (torch.cat([torch.ones_like(v0),
                                                      torch.zeros(2 * n, dtype=v0.dtype,
                                                                  device=dev)]),))
    jv, fd = dz[:n], (z[n : 2 * n] - z[2 * n :]) / (2 * DIFF_FD_EPS)
    err_fd = (jv - fd).abs().max().item()
    errors["d"] = dict(lanes=DIFF_FD_LANES, max_abs_err=err_fd, atol=DIFF_FD_ATOL,
                       jvp_abs_max=jv.abs().max().item())
    lap("d")
    check(bool(torch.isfinite(jv).all()) and err_fd < DIFF_FD_ATOL,
          f"diff (d): sphere jvp against central differences {err_fd} (atol {DIFF_FD_ATOL})")

    launches = launch_counts()
    emit("diff", model="quadruped", B=B, T=T, T_forward=min(T, DIFF_T_FWD), h=0.05,
         dtype="float32", B64=DIFF_B64, T64=DIFF_T64,
         **({"reduced": {"T": T, "T_forward": min(T, DIFF_T_FWD), "T_before": DIFF_T_FULL}}
            if T < DIFF_T_FULL else {}),
         seconds=seconds, errors=errors, launches=launches)
    for name, c in launches.items():
        check(c > 0, f"diff: kernel {name} was not launched in the phase")
    return row_launch_counts()


def atlas_case(dtype, device):
    """Atlas as phase atlas drives it: the mechanism on `device` in `dtype`,
    and its initial state made in float64 on the CPU and rounded once (as
    zoo_state makes the zoo's)."""
    import torch

    from dojo_tpu_torch import models
    from dojo_tpu_torch.core import tensor_map

    kw = dict(springs=1000.0, dampers=100.0, parse_springs=False, parse_dampers=False)
    pos = (0, 0, 0.9385 + ATLAS_LIFT)
    state = models.initialize(models.get_mechanism("atlas", device="cpu", **kw), "atlas",
                              body_position=pos)
    mech = models.get_mechanism("atlas", device=device, **kw).cast(dtype)
    return mech, tensor_map(lambda a: a.to(dtype).to(device), state)


def atlas_phase(B=ATLAS_B, B64=ATLAS_B64, step_B=ATLAS_STEP_B, K=ATLAS_K, device="cuda"):
    """Atlas's drop on the card.  (a) Its KKT (W = 38, N = 62, S = 244, 22
    levels; a lane over a CTA's shared memory at its real rows) through the
    kernels of csrc/ldu_lane.cu (ATLAS_VARIANTS: the packed factorize and
    solve, the lane matvec) against the plain versions (check_kernels:
    block LUs bitwise, the solve unrefined and refined once, the matvec,
    with the 33..72 class's limits) in float32 at B lanes, with the
    kernels-line rows factorize_packed, solve_packed and matvec_lane, and in
    float64 at B64 lanes (atlas_kkt); (b) from ATLAS_LIFT above its standing height, ATLAS_K32
    float32 steps on ATLAS_B32 lanes (finite states; success reported, not
    gated: dojo_tpu fails them too), then K float64 steps on step_B lanes:
    success (the rescue included), the smallest signed distance of any
    contact, finite states; for each, steps/s, iterations and rescued
    lanes; and the launches of each variant over both.  Returns (the
    launches of (b) per kernels-line row, the rows)."""
    import torch

    from dojo_tpu_torch import ldu_cuda as L
    from dojo_tpu_torch.contacts import signed_distances
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.simulate import make_step

    dev = torch.device(device)
    rows = {}
    for dt, lanes in (("float32", B), ("float64", B64)):
        t0 = time.perf_counter()
        dtype = getattr(torch, dt)
        mech, state = atlas_case(dtype, dev)
        sched, ds, blocks, rhs = model_kkt(mech, state, lanes, dev)
        variants = {n: L.variant(sched, n, dtype, ds.buf.numel())
                    for n in ("factorize", "solve", "matvec")}
        check(variants == ATLAS_VARIANTS,
              f"atlas {dt}: the kernels take the variants {variants}, not {ATLAS_VARIANTS}")
        L.reset_launches()
        errors, fact_k, x_k, mag = check_kernels(ds, blocks, rhs, f"atlas {dt}")
        for n, c in class_launch_counts().items():
            v = ATLAS_VARIANTS[n]
            check(c[v] > 0 and sum(c.values()) == c[v],
                  f"atlas {dt}: kernel {n} of variant {v} did not run alone: {c}")
        need = work(sched, lanes, blocks.element_size())
        need_real = work_real(sched, lanes, blocks.element_size())
        if dt == "float32":
            rows = kernel_rows(ds, blocks, fact_k, rhs, x_k, mag, errors, "atlas")
            kernels = {r["name"]: {k: r[k] for k in ("ms", "ms_one_lane", "plain_ms",
                                                     "library_ms", "bound_ms",
                                                     "bound_ms_real", "smem_bytes")}
                       for r in rows.values()}
        else:
            calls = {"factorize": lambda: L.factorize(ds, blocks),
                     "solve": lambda: L.solve(ds, fact_k, rhs),
                     "matvec": lambda: L.matvec(ds, blocks, x_k)}
            kernels = {n: dict(ms=time_ms(fn, 10), bound_ms=bound(*need[n], dt)[0],
                               bound_ms_real=bound(*need_real[n], dt)[0],
                               smem_bytes=ds.layout(n, dtype)["bytes"] if n == "matvec"
                               else ds.layout(n, dtype).bytes)
                       for n, fn in calls.items()}
        emit("atlas_kkt", model="atlas", dtype=dt, W=sched.width, N=sched.n_nodes,
             S=sched.n_slots, levels=len(sched.levels), B=lanes, variants=variants,
             lu_blocks_bitwise=errors["lu_blocks"], lu_identity=errors["lu_identity"],
             relres=errors["relres"], solve_scale=errors["solve_scale"],
             limits=errors["limits"],
             max_abs_err={n: errors[n] for n in ("factorize", "solve", "matvec")},
             kernels=kernels, seconds=time.perf_counter() - t0)

    # (b) the drop
    def drop(dtype, lanes, steps):
        mech, state = atlas_case(dtype, dev)
        topo, params = mech.topo, mech.params
        step = make_step(topo, SolverOptions(**ATLAS_OPTS), device=dev)
        st = tensor_map(lambda a: a.expand(lanes, *a.shape).contiguous(), state)
        z0 = state.x[0, 2].item()
        oks, its, rescued, min_sdf, per_step = [], [], 0, float("inf"), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            st, info = step(params, st)
            oks.append(info.success)
            its.append(info.iterations)
            rescued += int(info.rescued.sum())
            sdf = signed_distances(topo, params, st).min().item()
            min_sdf = min(min_sdf, sdf)
            per_step.append(dict(success=info.success.float().mean().item(),
                                 iterations=info.iterations.float().mean().item(),
                                 rescued=int(info.rescued.sum()), min_sdf=sdf,
                                 rvio_max=info.rvio.max().item()))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        h = float(params.timestep)
        out = dict(B=lanes, K=steps, h=h, dtype=str(dtype)[6:], dim=topo.dim, seconds=dt,
                   steps_per_s=lanes * steps / dt, sim_seconds_per_s=lanes * steps * h / dt,
                   success=torch.stack(oks).float().mean().item(),
                   mean_iters=torch.stack(its).float().mean().item(), rescued_lanes=rescued,
                   min_signed_distance=min_sdf, root_drop=z0 - st.x[:, 0, 2].min().item(),
                   per_step=per_step)
        check(all(bool(torch.isfinite(f).all()) for f in (st.x, st.q, st.v, st.w)),
              f"atlas: non-finite state after the {out['dtype']} drop")
        return out

    L.reset_launches()
    f32 = drop(torch.float32, ATLAS_B32, ATLAS_K32)
    f64 = drop(torch.float64, step_B, K)
    launches = class_launch_counts()
    success, min_sdf = f64["success"], f64["min_signed_distance"]
    emit("atlas", model="atlas", lift=ATLAS_LIFT, float32=f32, float64=f64,
         reduced={"steps": K, "reference_steps": max(10, int(round(1.0 / f64["h"])))},
         reference_fails_float32=True, launches=launches,
         gates=dict(success=ATLAS_SUCCESS, min_signed_distance=ATLAS_MIN_SDF))
    check(success >= ATLAS_SUCCESS, f"atlas: float64 success {success} < {ATLAS_SUCCESS}")
    check(min_sdf >= ATLAS_MIN_SDF, f"atlas: smallest signed distance {min_sdf} < {ATLAS_MIN_SDF}")
    for n, c in launches.items():
        v = ATLAS_VARIANTS[n]
        check(c[v] > 0, f"atlas: kernel {n} of variant {v} was not launched")
        check(sum(c.values()) == c[v], f"atlas: a kernel of another variant ran: {c}")
    return row_launch_counts(), rows


def main():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from dojo_tpu_torch import ldu_cuda as L, models
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.simulate import make_step

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build ----------------------------------------------------------------
    # the eight libraries at once (ldu.cu a dtype each, ldu_lane.cu a dtype
    # and kernel each), an nvcc process each; the packed factorize's two,
    # the longest builds, which only phase atlas launches, build on while
    # the phases before it run
    t = time.perf_counter()
    builds = L.start_builds()
    late = {key: f for key, f in builds.items() if key[0] == "ldu_lane.cu:factorize"}
    built = {key: f.result() for key, f in builds.items() if key not in late}
    for elem in (4, 8):
        L.library(elem=elem)
        for kernel in ("solve", "matvec"):
            L.lane_library(elem, kernel)
    emit("build", seconds=round(time.perf_counter() - t, 3), libraries=build_report(built),
         building=sorted(f"{name}:{elem}" for name, elem in late))

    # ---- kernels vs plain versions on the quadruped KKT ----------------------
    f32 = torch.float32
    mech = models.get_mechanism("quadruped", timestep=0.05).cast(f32)
    topo, params = mech.topo, mech.params
    state = models.initialize(mech, "quadruped")
    sched, ds, blocks, rhs = model_kkt(mech, state, B, dev)
    errors, fact_k, x_k, mag = check_kernels(ds, blocks, rhs, "quadruped")
    table = kernel_rows(ds, blocks, fact_k, rhs, x_k, mag, errors, "quadruped")
    emit("kernels", model="quadruped", B=B, dtype="float32", relres=errors["relres"],
         solve_scale=errors["solve_scale"], lu_identity=errors["lu_identity"],
         limits=errors["limits"],
         kernels=list(table.values()))
    emit("lu_swap", lanes=16, blocks=lu_swap_phase())
    step = make_step(topo, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30))
    bstate = tensor_map(lambda a: a.expand(B, *a.shape).contiguous(), state)
    u = torch.zeros(B, topo.nj, 6, dtype=f32, device=dev)

    # ---- the main path: quadruped contact steps -------------------------------
    # bench.py's chains: one untimed step from the initial state, then K
    # timed steps; the cold chain passes the neutral init of the initial
    # state as w_prev at every step, the warm chain the previous solution
    w_neutral = step.init_w(bstate.v, bstate.w, params)

    def chain(warm):
        st, info = step(params, bstate, u, w_prev=w_neutral)
        w_prev = info.w if warm else w_neutral
        oks, its, rescued = [], [], 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(K):
            st, info = step(params, st, u, w_prev=w_prev)
            w_prev = info.w if warm else w_neutral
            oks.append(info.success)
            its.append(info.iterations)
            rescued += int(info.rescued.sum())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        for f in (st.x, st.q, st.v, st.w):
            check(bool(torch.isfinite(f).all()), "non-finite state after a chain")
        return st, dict(
            steps_per_s=B * K / dt, seconds=dt,
            success=torch.stack(oks).float().mean().item(),
            mean_iters=torch.stack(its).float().mean().item(),
            rescued_lanes=rescued,
        )

    t = time.perf_counter()
    st1, info1 = step(params, bstate, u)
    torch.cuda.synchronize()
    check(tuple(st1.x.shape) == (B, topo.nb, 3) and bool(torch.isfinite(info1.w).all()),
          "validation step: bad shape or non-finite solution")
    validate = dict(seconds=time.perf_counter() - t,
                    success=info1.success.float().mean().item(),
                    mean_iters=info1.iterations.float().mean().item())

    L.reset_launches()
    _, cold = chain(False)
    cold["launches"] = launch_counts()
    _, warm = chain(True)
    launches = launch_counts()
    warm["launches"] = {k: launches[k] - cold["launches"][k] for k in launches}
    launches_steps = class_launch_counts()
    rows_steps = row_launch_counts()
    kernel_s = sum(launches[n] * table[n]["ms"] for n in launches) / 1e3
    emit("steps", B=B, K=K, h=0.05, dtype="float32", validate=validate, cold=cold, warm=warm,
         kernel_share=kernel_s / (cold["seconds"] + warm["seconds"]))
    for n, c in launches_steps.items():
        check(c["w16"] > 0, f"kernel {n} was not launched on the main path")
        check(sum(c.values()) == c["w16"], "steps: a kernel of another class than w16 ran")
    check(cold["success"] >= 0.9, f"cold chain success {cold['success']} < 0.9")

    # ---- where a step's time goes: one warm step under torch.profiler --------
    from torch.profiler import ProfilerActivity, profile

    st_w, info_w = step(params, bstate, u)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, st_w, u, w_prev=info_w.w)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    device_s, n_kernels, top_ops = profile_summary(prof)
    emit("profile", wall_s=wall, device_busy_s=device_s, device_busy_share=device_s / wall,
         cuda_kernels=n_kernels, top_cpu_ops=top_ops)

    # ---- reference: plain float64 path on the CPU, lane 0 ---------------------
    mech64 = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    s64 = tensor_map(lambda a: a[None], models.initialize(mech64, "quadruped"))
    step64 = make_step(mech64.topo, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30), device="cpu")
    ref, info64 = step64(mech64.params, s64)
    dx = (st1.x[0].cpu().double() - ref.x[0]).abs().max().item()
    dv = (st1.v[0].cpu().double() - ref.v[0]).abs().max().item()
    emit("reference", dx=dx, dv=dv, iters_f64=int(info64.iterations[0]),
         iters_f32=int(info1.iterations[0]))
    # float32 rounding through ~10 Newton iterations of a 356-dim KKT
    check(bool(info64.success[0]) and dx < 1e-5 and dv < 2e-4,
          f"card step disagrees with the float64 reference: dx={dx} dv={dv}")

    launches_mpc, shared_rows = mpc_phase()
    table.update(shared_rows)
    zoo_launches, zoo_rows = zoo_phase()
    table.update(zoo_rows)
    t = time.perf_counter()
    built = {key: f.result() for key, f in late.items()}
    for elem in (4, 8):
        L.lane_library(elem, "factorize")
    emit("build_late", waited=round(time.perf_counter() - t, 3), libraries=build_report(built))
    atlas_launches, atlas_rows = atlas_phase()
    table.update(atlas_rows)
    diff_launches = diff_phase()
    for row in table.values():
        kernel = row.get("class_row", row["name"])  # the kernel the row times
        row["launches"] = rows_steps[kernel]
        row["launches_mpc"] = launches_mpc[kernel]
        row["launches_zoo"] = zoo_launches[kernel]
        row["launches_atlas"] = atlas_launches[kernel]
        row["launches_diff"] = diff_launches[kernel]
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
