#!/usr/bin/env python3
"""Time the block-LDU kernels of one checkout on a CUDA card.

    python3 scripts/ldu_kernel_times.py [--root DIR] [--reps N]

Imports dojo_tpu_torch from DIR (default: this checkout), builds its
kernels, and prints one JSON line: the card's name and power limit
(nvidia-smi) and the mean device time in ms (chip_smoke.time_ms: CUDA
events behind a spin kernel) of
  - factorize, solve and matvec on the quadruped KKT at B=256 (W=14);
  - factorize, solve and matvec on humanoid's and walker's (W=22) and
    block's (W=70) KKT at B=64, bench_zoo's lanes, and factorize and solve
    for one lane alone;
  - factorize and solve on humanoid's, walker's and block's KKT in float64
    at B=64 and for one lane (null where the checkout's lane does not fit
    a CTA);
  - factorize and solve on the other 17..32 models' KKTs (snake, hopper,
    twister) at B=64;
  - solve and matvec with k=54 right-hand sides a factorization on the
    quadruped KKT at 1,280 lanes (the linearize's shape in bench.py's MPC).
The KKTs are chip_smoke.model_kkt's (each model's initial state, a seed);
time_ms_redone counts the timings made again because the host fell behind
the spin kernel (chip_smoke.time_ms).
Two checkouts run in turns (A, B, B, A) compare them on one card; the
wrappers' signatures it uses are those of every checkout since the
shared-factor argument rhs_per_fact came in.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as C  # inserts HERE into sys.path; the root goes first

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from dojo_tpu_torch import ldu_cuda as L, models

    C.check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    getattr(L, "build_all", L.library)()  # a checkout before the libraries a dtype: one
    dev, f32 = torch.device("cuda"), torch.float32
    out = {"root": os.path.abspath(args.root), "device": smi, "ms": {}}
    cases = (("quadruped", 256, dict(timestep=0.05)), ("humanoid", 64, {}), ("walker", 64, {}),
             ("block", 64, {}))
    for name, lanes, kw in cases:
        mech = models.get_mechanism(name, device=dev, **kw).cast(f32)
        _, ds, blocks, rhs = C.model_kkt(mech, models.initialize(mech, name), lanes, dev)
        fact = L.factorize(ds, blocks)
        x = L.solve(ds, fact, rhs)
        ms = out["ms"][f"{name}_B{lanes}"] = {
            "factorize": C.time_ms(lambda: L.factorize(ds, blocks), args.reps),
            "solve": C.time_ms(lambda: L.solve(ds, fact, rhs), args.reps),
            "matvec": C.time_ms(lambda: L.matvec(ds, blocks, x), args.reps),
        }
        if name in ("humanoid", "walker", "block"):
            for dtype in (f32, torch.float64):
                m = mech if dtype == f32 else models.get_mechanism(name, device=dev).cast(dtype)
                for b in (1, lanes):
                    key = f"{name}_B{b}" + ("_f64" if dtype != f32 else "")
                    if key in out["ms"]:
                        continue
                    _, ds_, bl, r = C.model_kkt(m, models.initialize(m, name), b, dev)
                    try:
                        f = L.factorize(ds_, bl)
                    except ValueError as e:  # the lane does not fit a CTA
                        out["ms"][key] = {"factorize": None, "solve": None, "error": str(e)}
                        continue
                    out["ms"][key] = {
                        "factorize": C.time_ms(lambda: L.factorize(ds_, bl), args.reps),
                        "solve": C.time_ms(lambda: L.solve(ds_, f, r), args.reps),
                    }
        if name == "quadruped":
            knots, k = 1280, 54
            _, ds, blocks, _ = C.model_kkt(mech, models.initialize(mech, name), knots, dev)
            fact = L.factorize(ds, blocks)
            gen = torch.Generator(device="cpu").manual_seed(1)
            flat = torch.randn((knots * k, mech.topo.dim), generator=gen, dtype=f32).to(dev)
            b = L.flat_to_nodes(ds.plan, flat).contiguous()
            xk = L.solve(ds, fact, b, k)
            ms["solve_k54_B1280"] = C.time_ms(lambda: L.solve(ds, fact, b, k), 5)
            ms["matvec_k54_B1280"] = C.time_ms(lambda: L.matvec(ds, blocks, xk, k), 5)
        torch.cuda.synchronize()
    for name in ("snake", "hopper", "twister"):
        mech = models.get_mechanism(name, device=dev).cast(f32)
        _, ds, blocks, rhs = C.model_kkt(mech, models.initialize(mech, name), 64, dev)
        fact = L.factorize(ds, blocks)
        out["ms"][f"{name}_B64"] = {
            "factorize": C.time_ms(lambda: L.factorize(ds, blocks), args.reps),
            "solve": C.time_ms(lambda: L.solve(ds, fact, rhs), args.reps),
        }
    out["time_ms_redone"] = C.time_ms.redone
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
