#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with elapsed seconds:
  device   — card name, and name + power limit from nvidia-smi;
  build    — nvcc build of dojo_tpu_torch/csrc/ldu.cu (first use);
  kernels  — the three block-LDU kernels against their plain PyTorch
             versions on the quadruped KKT at B=256, float32 (factorize
             also on L·U = PS·D), with times at B=256 and for one lane,
             and the dynamic shared memory each kernel was launched with;
  steps    — the quadruped contact step (h=0.05, B=256, float32,
             rtol=1e-6, btol=1e-4, max_iter=30): one validation step, then
             a cold and a warm chain of K steps, with success, Newton
             iterations, rescued lanes, steps/s and kernel launch counts;
  profile  — one warm step under torch.profiler: CUDA kernels launched,
             device busy share, and the top CPU operators by self time;
  reference— lane 0 of the validation step against one float64 step of the
             same state through the plain path on the CPU.
Then one {"kernels": [...]} line, the nvidia-smi line, and as the last line
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
H100 = {"bytes_per_s": 3.35e12, "f32_flops": 67e12, "f64_flops": 34e12}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps):
    """Mean device time of one call of fn, over reps calls after a warm-up.

    A spin kernel holds the stream while the calls are enqueued, so the
    CUDA events time the calls back to back on the device rather than the
    host's launch overhead (as long as a call's launches fit the queue)."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    fn()
    torch.cuda.synchronize()
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
    start, end = events()
    torch.cuda._sleep(int(2 * enqueue_s * cycles_per_s) + 10**5)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def work(sched, lanes, elem):
    """(bytes, flops) each kernel must move / execute for `lanes` lanes.

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
        "solve": (elem * lanes * ((len(edges) + 2 * N) * W * W + 2 * N * W), lanes * (fwd + bwd)),
        "matvec": (elem * lanes * (S * W * W + 2 * N * W), lanes * 2 * S * W * W),
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


def bound(nbytes, flops):
    t_b, t_f = nbytes / H100["bytes_per_s"], flops / H100["f32_flops"]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def main():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from dojo_tpu_torch import ldu, ldu_cuda as L, models
    from dojo_tpu_torch.blocks import make_assembler
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.graph import build_schedule
    from dojo_tpu_torch.residual import make_context, make_residual
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
    t = time.perf_counter()
    path, report = L.build()
    L.library()
    emit("build", seconds=round(time.perf_counter() - t, 3), library=os.path.basename(path),
         ptxas=[ln.strip() for ln in report.splitlines()
                if any(w in ln for w in ("registers", "spill", "Compiling"))])

    # ---- kernels vs plain versions on the quadruped KKT ----------------------
    f32 = torch.float32
    mech = models.get_mechanism("quadruped", timestep=0.05).cast(f32)
    topo, params = mech.topo, mech.params
    state = models.initialize(mech, "quadruped")
    sched = build_schedule(topo)
    ds = L.DeviceSchedule(sched, dev)
    step = make_step(topo, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30))
    bstate = tensor_map(lambda a: a.expand(B, *a.shape).contiguous(), state)
    u = torch.zeros(B, topo.nj, 6, dtype=f32, device=dev)
    ctx = make_context(topo, bstate, params, u)
    gen = torch.Generator(device="cpu").manual_seed(0)
    w0 = step.init_w(bstate.v, bstate.w, params)
    bw = w0 + 0.01 * torch.randn(w0.shape, generator=gen, dtype=f32).to(dev)
    mu = torch.full((B,), 1e-3, dtype=f32, device=dev)
    blocks = make_assembler(topo, sched)(bw, ctx, params, mu).contiguous()
    r = make_residual(topo)(bw, ctx, params, mu)
    rhs = L.flat_to_nodes(ds.plan, r).contiguous()

    fact_k = L.factorize(ds, blocks)
    fact_p = ldu.factorize(ds.plan, blocks)
    err_fact = (fact_k[0] - fact_p[0]).abs().max().item()
    check(err_fact < 5e-3, f"factorize: factored blocks differ by {err_fact} (atol 5e-3)")
    # LU and PS may differ from the plain version's where pivot magnitudes
    # tie to rounding; the contract on them is L·U = PS·D for every node
    err_lu = lu_identity_err(*fact_k, sched.n_nodes)
    check(err_lu < 1e-4, f"factorize: L·U − PS·D is {err_lu} of |PS·D| (1e-4)")
    # solve + refine (1 sweep): kernel route vs plain route, to 2e-5 of scale
    x_k = L.solve_refine(ds, blocks, fact_k, rhs, 1)
    x_p = ldu.solve(ds.plan, fact_p, rhs)
    x_p = x_p + ldu.solve(ds.plan, fact_p, rhs - ldu.matvec(ds.plan, blocks, x_p))
    scale = x_p.abs().max().item()
    err_solve = (x_k - x_p).abs().max().item()
    check(err_solve / scale < 2e-5, f"solve: {err_solve} of scale {scale} (2e-5)")
    res = rhs - ldu.matvec(ds.plan, blocks, x_k)
    relres = (res.flatten(1).norm(dim=1) / rhs.flatten(1).norm(dim=1)).max().item()
    check(relres < 1e-4, f"solve: relative residual {relres} (1e-4)")
    # matvec: both sum each row in slot order; bound the rounding by
    # 1e-5·Σ|E||x| (W=14 f32 products and the slot sum, ~1e-6)
    y_k = L.matvec(ds, blocks, x_k)
    y_p = ldu.matvec(ds.plan, blocks, x_k)
    mag = ldu.matvec(ds.plan, blocks.abs(), x_k.abs())
    err_mv = (y_k - y_p).abs().max().item()
    check(bool(((y_k - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"matvec: max error {err_mv} exceeds 1e-5·Σ|E||x|")

    # library yardstick for the matvec: one block-sparse (BSR) product over
    # the block-diagonal-over-lanes matrix, blocks sorted by (row, col) node
    node_pair = {s: ab for ab, s in sched.slot.items()}
    perm = torch.as_tensor(sorted(node_pair, key=node_pair.get), device=dev)
    W, N, S = sched.width, sched.n_nodes, sched.n_slots
    col = ds.plan.slot_b[perm].repeat(B) + torch.arange(B, device=dev).repeat_interleave(S) * N
    counts = torch.bincount(ds.plan.slot_a, minlength=N).repeat(B)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    bsr = torch.sparse_bsr_tensor(crow, col, blocks[:, perm].reshape(B * S, W, W),
                                  size=(B * N * W, B * N * W))
    xv = x_k.reshape(B * N * W, 1)
    y_lib = (bsr @ xv).reshape(B, N, W)
    err_lib = (y_lib - y_p).abs().max().item()
    check(bool(((y_lib - y_p).abs() <= 1e-5 * mag + 1e-30).all()),
          f"BSR yardstick disagrees with the plain matvec by {err_lib}")

    need = work(sched, B, 4)
    timings = {
        "factorize": (lambda: L.factorize(ds, blocks), lambda: ldu.factorize(ds.plan, blocks), None),
        "solve": (lambda: L.solve(ds, fact_k, rhs), lambda: ldu.solve(ds.plan, fact_k, rhs), None),
        "matvec": (lambda: L.matvec(ds, blocks, x_k), lambda: ldu.matvec(ds.plan, blocks, x_k),
                   lambda: bsr @ xv),
    }
    errors = {"factorize": err_fact, "solve": err_solve, "matvec": err_mv}
    replaces = {
        "factorize": "dojo_tpu/pallas_ldu.py:229",
        "solve": "dojo_tpu/pallas_ldu.py:307",
        "matvec": "dojo_tpu/pallas_ldu.py:324",
    }
    # one lane alone: the time of a lane's dependency chain (B=256 adds the
    # traffic of all lanes and two lanes per SM)
    b1, r1 = blocks[:1].contiguous(), rhs[:1].contiguous()
    f1 = L.factorize(ds, b1)
    lane_ms = {"factorize": time_ms(lambda: L.factorize(ds, b1), 20),
               "solve": time_ms(lambda: L.solve(ds, f1, r1), 20)}
    table = {}
    for k, (name, (kern, plain, lib)) in enumerate(timings.items()):
        ms = time_ms(kern, 20)
        # the cap the runtime holds for the kernel, which its launcher sets
        # to the bytes of each launch
        smem = L.library().ldu_kernel_smem(k, 4)
        check(smem > 0, f"{name}: cannot read the kernel's shared-memory attribute")
        plain_ms = time_ms(plain, 3)
        lib_ms = time_ms(lib, 20) if lib is not None else None
        bound_ms, bound_by = bound(*need[name])
        table[name] = dict(
            name=name, route="cuda", source="dojo_tpu_torch/csrc/ldu.cu",
            replaces=replaces[name], launches=0, max_abs_err=errors[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms, ms_one_lane=lane_ms.get(name), smem_bytes=smem,
        )
    emit("kernels", B=B, dtype="float32", relres=relres, solve_scale=scale, lu_identity=err_lu,
         kernels=[dict(t, bytes=need[t["name"]][0], flops=need[t["name"]][1])
                  for t in table.values()])

    # ---- the main path: quadruped contact steps -------------------------------
    def chain(warm):
        st, w_prev = bstate, None
        oks, its, rescued = [], [], 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(K):
            st, info = step(params, st, u, w_prev=w_prev if warm else None)
            w_prev = info.w
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
    cold["launches"] = {fn.__name__: fn.launches for fn in (L.factorize, L.solve, L.matvec)}
    _, warm = chain(True)
    launches = {fn.__name__: fn.launches for fn in (L.factorize, L.solve, L.matvec)}
    warm["launches"] = {k: launches[k] - cold["launches"][k] for k in launches}
    kernel_s = sum(launches[n] * table[n]["ms"] for n in table) / 1e3
    emit("steps", B=B, K=K, h=0.05, dtype="float32", validate=validate, cold=cold, warm=warm,
         kernel_share=kernel_s / (cold["seconds"] + warm["seconds"]))
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was not launched on the main path")
    check(cold["success"] >= 0.9, f"cold chain success {cold['success']} < 0.9")

    # ---- where a step's time goes: one warm step under torch.profiler --------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st_w, info_w = step(params, bstate, u)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, st_w, u, w_prev=info_w.w)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_s = sum(e.device_time for e in kernels) / 1e6
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    emit("profile", wall_s=wall, device_busy_s=device_s, device_busy_share=device_s / wall,
         cuda_kernels=len(kernels),
         top_cpu_ops=[dict(op=e.key, calls=e.count, self_cpu_ms=e.self_cpu_time_total / 1e3)
                      for e in ops[:8]])

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

    for n in table:
        table[n]["launches"] = launches[n]
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
