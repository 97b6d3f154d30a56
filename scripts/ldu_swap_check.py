#!/usr/bin/env python3
"""Hold the factorize kernels of checkouts to this checkout's plain block LU
on a CUDA card.

    python3 scripts/ldu_swap_check.py [--root DIR ...]

The inputs are made once, in float32, in this checkout:
  - chip_smoke.isolated_blocks (random, dup and comb blocks, seeds 0-2,
    16 lanes) on the quadruped's (W=14), humanoid's (22) and block's (70)
    schedules: each node's block factored as made;
  - the quadruped KKT at B=256 (chip_smoke.model_kkt);
  - the quadruped KKT at every converged plant knot (chip_smoke.plant_knots,
    the lanes stepped by this checkout's kernels).
For each DIR (default: this checkout) a child process imports
dojo_tpu_torch from DIR, builds its kernels and factorizes the inputs.
Each factorization's block LUs are held to ldu.blu_factor of this checkout
(chip_smoke.lu_vs_plain).  Prints one JSON line: the card's name and power
limit (nvidia-smi), and per DIR and input the blocks, the blocks not
bitwise equal, the most ulps apart, the blocks floored where the plain one
is not, the blocks at the floor and the smallest pivot.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"quadruped": dict(timestep=0.05), "humanoid": {}, "block": {}}


def dump(root, src, dst):
    """Factorize the inputs in `src` with the kernels of the checkout at
    `root`; save (fb, LU, PS) per input to `dst`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dojo_tpu_torch import ldu_cuda as L, models
    from dojo_tpu_torch.graph import build_schedule

    out = {}
    for case, (name, blocks) in torch.load(src).items():
        sched = build_schedule(models.get_mechanism(name, device="cpu", **MODELS[name]).topo)
        out[case] = [t.cpu() for t in L.factorize(L.DeviceSchedule(sched, "cuda"), blocks.cuda())]
    torch.save(out, dst)


def inputs(dev):
    """{case: (model, blocks on the CPU)}."""
    import chip_smoke as C
    import torch

    from dojo_tpu_torch import models
    from dojo_tpu_torch.blocks import make_assembler
    from dojo_tpu_torch.core import SolverOptions, tensor_map
    from dojo_tpu_torch.gradients import make_rollout_linearize_minimal, to_maximal, to_minimal
    from dojo_tpu_torch.graph import build_schedule
    from dojo_tpu_torch.mpc import trot_spring_params
    from dojo_tpu_torch.residual import make_context, pad_inputs

    cases = {}
    for name, kw in MODELS.items():
        sched = build_schedule(models.get_mechanism(name, device="cpu", **kw).topo)
        for kind in ("random", "dup", "comb"):
            for seed in range(3):
                cases[f"{name}_{kind}_{seed}"] = (
                    name, C.isolated_blocks(sched, kind, seed, 16, "cpu"))
    mech = models.get_mechanism("quadruped", device=dev, **MODELS["quadruped"]).cast(torch.float32)
    topo = mech.topo
    sched, _, blocks, _ = C.model_kkt(mech, models.initialize(mech, "quadruped"), C.B, dev)
    cases["quadruped_kkt_B256"] = ("quadruped", blocks.cpu())
    params = trot_spring_params(mech, springs=40.0, dampers=4.0)
    plant_step = make_rollout_linearize_minimal(topo, SolverOptions(**C.PLANT_OPTS), device=dev)[0]
    s0 = models.initialize(mech, "quadruped", body_position=(0, 0, -0.13))
    y0 = to_minimal(topo, mech.params, tensor_map(lambda a: a[None], s0))[0]
    conv, (y, u, w, mu) = C.plant_knots(topo, params, plant_step, y0, most=C.PLANT_LANES)
    ctx = make_context(topo, to_maximal(topo, params, y), params, pad_inputs(topo, u))
    blocks = make_assembler(topo, sched, dev)(w, ctx, params, mu)
    cases[f"quadruped_plant_knots_{len(conv)}"] = ("quadruped", blocks.contiguous().cpu())
    return cases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append")
    ap.add_argument("--dump", nargs=2, metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        return dump(args.root[0], *args.dump)
    sys.path.insert(0, HERE)
    import chip_smoke as C  # inserts HERE into sys.path
    import torch

    from dojo_tpu_torch import models
    from dojo_tpu_torch.graph import build_schedule

    C.check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    scheds = {n: build_schedule(models.get_mechanism(n, device="cpu", **kw).topo)
              for n, kw in MODELS.items()}
    cases = inputs(torch.device("cuda"))
    result = {"device": smi, "roots": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "inputs.pt")
        torch.save(cases, src)
        for root in args.root or [HERE]:
            dst = os.path.join(tmp, "factors.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, "--dump",
                            src, dst], check=True)
            fact = torch.load(dst)
            result["roots"][os.path.abspath(root)] = {
                case: C.lu_vs_plain(scheds[name], *fact[case])
                for case, (name, _) in cases.items()}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
