#!/usr/bin/env python3
"""The W <= 16 shared-factor solve against the k = 1 solve kernel and the
plain solves on a CUDA card, unrefined.

    python3 scripts/shared_solve_check.py

Inputs (float32, quadruped, h = 0.05): the KKT of chip_smoke.model_kkt
(μ = 1e-3) at 5 knots with k = 3 and k = 54 random columns, and the KKT at
256 perturbed standing lanes (seeded, random inputs) stepped once at the
controller's options (μ = 1e-4), k = 54.  For each it prints one JSON
line: the per-column error against the plain float64 solve on the same
factors, relative to the column's largest entry, at the 50th, 90th and
99th percentile and the largest, of the shared-factor kernel, the k = 1
kernel (the factors repeated a column) and the plain float32 solve; the
columns in which any two of them differ in any bit; and per node (its
level) the share of entries in which the two kernels differ.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import chip_smoke as C
    import numpy as np
    import torch

    from dojo_tpu_torch import ldu, ldu_cuda as L, models
    from dojo_tpu_torch.blocks import make_assembler
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_maximal, to_minimal
    from dojo_tpu_torch.graph import build_schedule
    from dojo_tpu_torch.mpc import trot_spring_params
    from dojo_tpu_torch.residual import make_context, pad_inputs

    C.check(torch.cuda.is_available(), "no CUDA device")
    dev, f32 = torch.device("cuda"), torch.float32
    mech = models.get_mechanism("quadruped", timestep=0.05, device=dev).cast(f32)
    topo = mech.topo
    sched = build_schedule(topo)
    ds = L.DeviceSchedule(sched, dev)
    level_of = {int(n): li for li, lv in enumerate(sched.levels) for n in lv.nodes}

    def stats(name, blocks, k, seed=1):
        fact = L.factorize(ds, blocks)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        flat = torch.randn((blocks.shape[0] * k, topo.dim), generator=gen, dtype=f32).to(dev)
        rhs = L.flat_to_nodes(ds.plan, flat).contiguous()
        xm = L.solve(ds, fact, rhs, k)
        x1 = L.solve(ds, [f.repeat_interleave(k, 0) for f in fact], rhs)
        xp = ldu.solve(ds.plan, fact, rhs, k)
        x64 = ldu.solve(ds.plan, [f.double() for f in fact], rhs.double(), k)
        cs = x64.abs().flatten(1).amax(1)
        pct = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=dev)
        err = lambda x: ((x.double() - x64).abs().flatten(1).amax(1) / cs).quantile(pct).tolist()
        cols = lambda a, b: int((a != b).flatten(1).any(1).sum())
        per_node = (xm != x1).float().mean(dim=(0, 2)).tolist()
        print(json.dumps(dict(
            name=name, knots=blocks.shape[0], k=k, err_multi=err(xm), err_k1=err(x1),
            err_plain=err(xp), multi_vs_k1_cols=cols(xm, x1),
            multi_vs_k1_max=(xm - x1).abs().max().item(), k1_vs_plain_cols=cols(x1, xp),
            multi_vs_plain_cols=cols(xm, xp),
            per_node=[(n, level_of[n], round(v, 4)) for n, v in enumerate(per_node)])), flush=True)

    _, _, blocks, _ = C.model_kkt(mech, models.initialize(mech, "quadruped"), 5, dev)
    stats("kkt_mu1e-3_B5", blocks, 3)
    stats("kkt_mu1e-3_B5", blocks, 54)
    params = trot_spring_params(mech, springs=40.0, dampers=4.0)
    step = make_rollout_linearize_minimal(
        topo, SolverOptions(rtol=1e-4, btol=1e-3, max_iter=16, rescue=True), device=dev)[0]
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(topo, mech.params, tensor_map(lambda a: a[None], s0))[0]
    n = 256
    rng = np.random.default_rng(0)
    py = np.repeat(y0.cpu().numpy()[None], n, 0)
    py[:, :2] += rng.normal(scale=0.01, size=(n, 2))
    py[:, 6:9] += rng.normal(scale=0.02, size=(n, 3))
    pu = rng.normal(scale=0.5, size=(n, topo.input_dim)).astype(np.float32)
    y, u = torch.as_tensor(py, device=dev), torch.as_tensor(pu, device=dev)
    _, w, mu, _ = step(params, y, u)
    ctx = make_context(topo, to_maximal(topo, params, y), params, pad_inputs(topo, u))
    stats("rt_knots", make_assembler(topo, sched, dev)(w, ctx, params, mu).contiguous(), 54)


if __name__ == "__main__":
    main()
