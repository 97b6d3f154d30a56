#!/usr/bin/env python3
"""Split the real-width factorize and solve kernels' time by phase on a card.

    python3 scripts/ldu_phase_split.py [--models humanoid,walker,block,atlas] [--lanes 1,64]
                                       [--root DIR] [--out FILE]

Builds csrc/ldu.cu with -DLDU_PHASES, in which lane 0
of each warp of the real-width factorize and solve (17..72) writes
clock64() at every phase boundary, launches that build's factorize and
solve on each model's KKT (chip_smoke.model_kkt, float32) at each batch
size, and prints
one JSON line: the card's name and power limit (nvidia-smi), the SM clock
(cycles per second of torch.cuda._sleep against CUDA events), and per
model and batch, in µs (the mean over the CTAs):
  factorize — staging (and its steps: the slots' places read, the
              copies issued, the copies arrived; and at a 33..72 CTA LU
              one pivot, csrc/ldu.cu PROBE_K, split: the pivot picked,
              rows k and p loaded, the rows updated, the next candidate
              stored, the barrier); per level the block LUs
              (at a 33..72 level over 32 wide, the CTA's LUs, whose
              barriers are inside), the X columns, the Schur tasks, and
              the wait at each of the three CTA barriers; write-back of
              fb, LU and PS (fb alone);
  solve     — staging (with PS's compact form, and the steps as above);
              per level pass the edge row dots, the node solves and the
              barrier; write-back; and at a 33..72 node wider than 32 (the
              CTA's last such node solve) its forward and backward
              substitution.
A phase ends when its last warp is done; a barrier's wait runs from there
to the barrier's release.  Also the instrumented and the plain kernels'
times (chip_smoke.time_ms), the cost of the stamps.

A model whose lane is over a CTA at its real rows (atlas) takes the
kernels of csrc/ldu_lane.cu: the checkout's packed factorize and solve
(ldu_packed_*), or, in a checkout from before them, the lane factorize and
solve that keep the lane in global memory (ldu_lane_*).  That source is
built with -DLDU_PHASES through a small probe source that includes it and
sets its stamp buffer (ldu_probe_set_stamps), and the split adds its
summary: the staging (the copy into fb, or the packed staging), level 0,
levels 1 and on, the write-back; the solve's staging, forward and backward
passes.  --root DIR imports dojo_tpu_torch from another checkout (its
sources built in its own _build/), so that parent and change are split
in one call.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402

PROBE_SOURCE = """// probe of the lane kernels' phases (scripts/ldu_phase_split.py)
#include "{lane}"
extern "C" int ldu_probe_set_stamps(void* p) {{
  return (int)cudaMemcpyToSymbol(ldu_stamps, &p, sizeof(p));
}}
extern "C" int ldu_probe_stamps_per_cta() {{ return STAMPS; }}
"""


def lane_probe(L):
    """The checkout's csrc/ldu_lane.cu built with -DLDU_PHASES (float32)
    behind a probe source that sets its stamps: (library, stamps a CTA)."""
    src = os.path.join(L.BUILD_DIR, "ldu_probe.cu")
    os.makedirs(L.BUILD_DIR, exist_ok=True)
    with open(src, "w") as f:
        f.write(PROBE_SOURCE.format(lane=L.LANE_SOURCE))
    lib = ctypes.CDLL(L.build(("LDU_PHASES", "LDU_ELEM=4"), src)[0])
    lib.ldu_probe_set_stamps.argtypes = [ctypes.c_void_p]
    return lib, lib.ldu_probe_stamps_per_cta()


def lane_calls(L, lib, ds, B, blocks, fb, lu, ps, rhs, x):
    """(factorize, solve) launches of the lane library's kernels for atlas:
    the packed ones where the checkout has them, else the lane ones."""
    f32, p = torch.float32, ctypes.c_void_p
    stream = lambda: torch.cuda.current_stream().cuda_stream
    packed = hasattr(lib, "ldu_packed_factorize_f32")
    fname, sname = (("ldu_packed_factorize_f32", "ldu_packed_solve_f32") if packed
                    else ("ldu_lane_factorize_f32", "ldu_lane_solve_f32"))
    fn_f, fn_s = getattr(lib, fname), getattr(lib, sname)
    fn_f.argtypes = [p, p, ctypes.c_int, p, p, p, p, p]
    fn_s.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p]
    struct = ds.struct_of("packed") if packed else ds.lane_struct()
    fact = lambda: fn_f(ctypes.byref(struct), ctypes.byref(ds.layout("factorize", f32)), B,
                        blocks.data_ptr(), fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), stream())
    solve = lambda: fn_s(ctypes.byref(struct), ctypes.byref(ds.layout("solve", f32)), B, 1,
                         fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), rhs.data_ptr(),
                         x.data_ptr(), stream())
    return fact, solve, "packed" if packed else "lane"


def sm_cycles_per_s():
    """The SM clock, from torch.cuda._sleep's spin (clock64 cycles) timed
    by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**6)
    start.record()
    torch.cuda._sleep(10**8)
    end.record()
    torch.cuda.synchronize()
    return 10**8 / (start.elapsed_time(end) / 1e3)


def stamp_buffer(set_stamps, B, per_cta):
    """A stamp buffer for B CTAs, set as the instrumented kernels' target."""
    buf = torch.zeros(B * per_cta * 8, dtype=torch.int64, device="cuda")
    rc = set_stamps(buf.data_ptr())
    C.check(rc == 0, f"ldu_set_stamps: CUDA error {rc}")
    return buf


def stamps_of(launch, buf, B, per_cta):
    """Run `launch` with the stamp buffer zeroed: (B, per_cta, 8) int64 on
    the CPU, 0 where a warp wrote no stamp."""
    buf.zero_()
    launch()
    torch.cuda.synchronize()
    return buf.view(B, per_cta, 8).cpu()


def last(st, i):
    """The latest stamp i over the warps of each CTA, 0 where none wrote it."""
    return st[:, i].amax(dim=1)


def split(st, L_, us, kernel, variant=None):
    """Per-CTA phase times in µs (mean over CTAs)."""
    mean = lambda a: float(a.double().mean()) / us
    start = st[:, 0].amin(dim=1)
    staged = last(st, 1)
    out = {"staging": mean(staged - start), "levels": []}
    prev = staged
    if kernel == "factorize":
        for lv in range(L_):
            b = 3 + 6 * lv
            lu, b1, x, b2, sc, b3 = (last(st, b + k) for k in range(6))
            out["levels"].append({"lu": mean(lu - prev), "bar1": mean(b1 - lu), "x": mean(x - b1),
                                  "bar2": mean(b2 - x), "schur": mean(sc - b2),
                                  "bar3": mean(b3 - sc)})
            prev = b3
        end = last(st, 3 + 6 * L_)
    else:
        for p in range(2 * L_):
            b = 3 + 3 * p
            rows, work, bar = (last(st, b + k) for k in range(3))
            rows = torch.where(rows > 0, rows, prev)
            out["levels"].append({"row_dots": mean(rows - prev), "node_solves": mean(work - rows),
                                  "bar": mean(bar - work)})
            prev = bar
        end = last(st, 3 + 6 * L_)
    out["write_back"] = mean(end - prev)
    out["total"] = mean(end - start)
    # staging's steps: the places read, the copies issued, the copies
    # arrived, (solve) PS in compact form; (factorize) fb written
    sub = st.shape[1] - 11
    steps = [last(st, sub + k) for k in range(3)]
    out["staging_steps"] = {"places": mean(steps[0] - start), "issue": mean(steps[1] - steps[0]),
                            "arrive": mean(steps[2] - steps[1])}
    if kernel == "solve":
        out["staging_steps"]["ps_compact"] = mean(last(st, sub + 3) - steps[2])
        probe = [last(st, sub + 5 + k) for k in range(3)]
        if bool((probe[0] > 0).all()):  # a wide node's wide_node_solve: PS·v, forward, backward
            out["wide_node_solve"] = {"forward": mean(probe[1] - probe[0]),
                                      "backward": mean(probe[2] - probe[1])}
    else:
        out["write_back_fb"] = mean(last(st, sub + 4) - prev)
        probe = [last(st, sub + 5 + k) for k in range(6)]
        if variant == "packed":  # level 0 from its start: group LUs done, narrow LUs done
            names = ("group_lus", "narrow_lus")
            out["level0_probe"] = {nm: mean(b - staged) for nm, b in zip(names, probe)}
        elif bool((probe[0] > 0).all()):  # a 33..72 CTA LU's pivot PROBE_K, warp by warp's last
            names = ("pick", "rows", "update", "candidate", "barrier")
            out["pivot_probe"] = {nm: mean(b - a) for nm, a, b in zip(names, probe, probe[1:])}
    for k in out["levels"][0]:
        out[f"sum_{k}"] = sum(lv[k] for lv in out["levels"])
    if kernel == "factorize":
        out["level0"] = sum(out["levels"][0].values())
        out["levels_after_0"] = sum(sum(lv.values()) for lv in out["levels"][1:])
    else:
        out["forward"] = sum(sum(lv.values()) for lv in out["levels"][:L_])
        out["backward"] = sum(sum(lv.values()) for lv in out["levels"][L_:])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="humanoid,walker,block")
    ap.add_argument("--lanes", default="1,64")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--build-only", action="store_true",
                    help="build the instrumented libraries and stop (no card needed)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from dojo_tpu_torch import ldu_cuda as L, models

    if args.build_only:
        L.build(("LDU_PHASES", "LDU_ELEM=4"))
        lane_probe(L)
        return

    C.check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = L.library(4, ("LDU_PHASES",))  # the float32 entry points, with the stamps
    per_cta = lib.ldu_stamps_per_cta()
    us = sm_cycles_per_s() / 1e6
    dev, f32 = torch.device("cuda"), torch.float32
    out = {"root": os.path.abspath(args.root), "device": smi, "sm_cycles_per_us": us,
           "split": {}}
    for name in args.models.split(","):
        mech = models.get_mechanism(name, device=dev).cast(f32)
        for B in (int(b) for b in args.lanes.split(",")):
            sched, ds, blocks, rhs = C.model_kkt(mech, models.initialize(mech, name), B, dev)
            cls = L.width_class(sched.width)
            C.check(cls in ("w32", "w72"), f"{name}: not in a real-width class")
            fb, lu, ps = (torch.empty_like(t) for t in L.factorize(ds, blocks))
            x = torch.empty_like(rhs)
            stream = lambda: torch.cuda.current_stream().cuda_stream
            set_stamps, n_stamps = lib.ldu_set_stamps, per_cta
            fact = lambda: lib.ldu_factorize_f32(
                ctypes.byref(ds.struct), ctypes.byref(ds.layout("factorize", f32)), B,
                blocks.data_ptr(), fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), stream())
            solve = lambda: lib.ldu_solve_f32(
                ctypes.byref(ds.struct), ctypes.byref(ds.layout("solve", f32)), B, 1, 0,
                fb.data_ptr(), lu.data_ptr(), ps.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                stream())
            var = L.variant(sched, "factorize", f32)
            if var in ("packed", "lane"):  # the lane library's kernels
                probe, n_stamps = lane_probe(L)
                set_stamps = probe.ldu_probe_set_stamps
                fact, solve, var = lane_calls(L, probe, ds, B, blocks, fb, lu, ps, rhs, x)
            per_cta = n_stamps
            buf = stamp_buffer(set_stamps, B, per_cta)
            for fn in (fact, solve):  # warm up
                C.check(fn() == 0, "launch failed")
            torch.cuda.synchronize()
            ref = L.factorize(ds, blocks)
            C.check(all(torch.equal(a, b) for a, b in zip((fb, lu, ps), ref)),
                    f"{name}: the instrumented factorize differs from the plain build's")
            C.check(torch.equal(x, L.solve(ds, ref, rhs)),
                    f"{name}: the instrumented solve differs from the plain build's")
            nl = len(sched.levels)
            res = {"variant": var}
            kernels = (("factorize", fact, lambda: L.factorize(ds, blocks)),
                       ("solve", solve, lambda: L.solve(ds, ref, rhs)))
            for kernel, fn, plain_fn in kernels:
                st = stamps_of(fn, buf, B, per_cta)
                res[kernel] = split(st, nl, us, kernel, var)
                res[kernel]["ms_instrumented"] = C.time_ms(fn, 20)
                res[kernel]["ms_plain_build"] = C.time_ms(plain_fn, 20)
            out["split"][f"{name}_B{B}"] = res
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
