#!/usr/bin/env python3
"""K5 (`batch_sweep_t`, the batched BCD sweep) of one source tree on the
card: config 2's A_t (625 x 80 x 5000, l1) at L = 1, 4, 10 and 16 and at
L = 10 with a CV keep mask and row mask, and config 4's group tile (1000 x
200 x 20000, group_l2 over groups of 200 with weights) at L = 10.

    python3 scripts/time_sweep_batch.py [--root DIR]
        [--only SETTING[,SETTING]]

Imports `convex_optimization_tpu_torch` from DIR (default: this checkout)
and `chip_smoke.py` from this checkout, so that two trees (a commit and its
parent unpacked beside it) run the same measurement in turn on one card.
A_t is random (a seeded device generator, columns of unit norm), b too;
each sweep starts from X = 0, R = -b (as a path does) on a geometric lam
grid from 0.95 lam_max.  Each setting is checked against the plain version
at chip_smoke.check_k5's tolerances (1e-5, 1e-4 past 64 blocks; config 4
on its first 16 blocks) and timed with CUDA events over REPS launches; the
JSON line carries ms per sweep, us per block, the bound (bytes at 3.35 TB/s
or f32 operations at 67 TFLOP/s), the plan (on a tree that has
`bcd_sweep_batch.batch_plan`), each CUDA kernel's mean device time per
call from `torch.profiler`, the kernel build's seconds and the card's name
and power limit.  A first line gives the seconds of compiling
csrc/sweep_batch.cu alone.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
REPS = 10
C2 = (625, 80, 5000)
C4 = (1000, 200, 20_000)
C4_GSIZE = 200
#: name -> (A_t shape, L, group, masked)
SETTINGS = {
    "config2_L1": (C2, 1, False, False),
    "config2_L4": (C2, 4, False, False),
    "config2_L10": (C2, 10, False, False),
    "config2_L16": (C2, 16, False, False),
    "config2_L10_cv_masks": (C2, 10, False, True),
    "config4_group_L10": (C4, 10, True, False),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default=",".join(SETTINGS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_sweep_batch: needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is
    from time_matvec import trace_us

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    gpu, power = [s.strip() for s in cs.card_line().split(",", 1)]
    _build.load()
    build_s = _build.build_seconds
    print(json.dumps({"root": root, "source": "sweep_batch.cu",
                      "compile_s": compile_seconds(_build, "sweep_batch.cu"),
                      "library_build_s": build_s, "gpu": gpu,
                      "power_limit": power}), flush=True)
    dev = torch.device("cuda", 0)
    data: dict = {}
    for name in args.only.split(","):
        shape, L, group, masked = SETTINGS[name]
        if shape not in data:
            data.clear()
            data[shape] = make_data(shape, group, dev)
        out = run_setting(cs, trace_us, data[shape], L, group, masked)
        out.update({"root": root, "setting": name, "A_t": list(shape),
                    "build_s": build_s, "gpu": gpu, "power_limit": power})
        print(json.dumps(out), flush=True)


def compile_seconds(_build, name: str) -> float:
    """Wall seconds of one nvcc -c of csrc/<name> alone, with the library's
    flags (the library's own build runs every source at once)."""
    import subprocess
    import time

    src = os.path.join(os.path.dirname(_build.sources()[0]), name)
    obj = os.path.join(_build._BUILD_DIR, f"time_{name}.o")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *flags, "-c", "-o", obj, src],
                   check=True, capture_output=True)
    took = time.perf_counter() - t0
    os.remove(obj)
    return took


def make_data(shape, group: bool, dev) -> dict:
    import torch

    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = shape
    n = nb * B
    gen = torch.Generator(device=dev).manual_seed(nb)
    A_t = torch.randn(nb, B, m, generator=gen, device=dev)
    A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
    b = torch.randn(m, generator=gen, device=dev)
    z = mv.neg_at_r_t_plain(A_t, b, torch.zeros(n, device=dev), 0.0)
    d = {"A_t": A_t, "b": b, "steps": k1.block_steps(
        mv.block_power_t_plain(A_t), 0.0)}
    if group:
        ng = n // C4_GSIZE
        d["w"] = 0.5 + torch.rand(ng, generator=gen, device=dev)
        d["lmax"] = float((torch.linalg.vector_norm(z.view(ng, C4_GSIZE),
                                                    dim=1) / d["w"]).max())
    else:
        d["lmax"] = float(z.abs().max())
    cpu = torch.Generator(device="cpu").manual_seed(nb + 1)
    d["keep"] = (torch.rand(n, generator=cpu) > 0.1).to(dev)
    d["rm"] = (torch.rand(m, generator=cpu) > 1 / 3).to(torch.float32).to(dev)
    return d


def run_setting(cs, trace_us, d: dict, L: int, group: bool,
                masked: bool) -> dict:
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.models.penalties import group_l2, l1
    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb

    A_t, b, steps = d["A_t"], d["b"], d["steps"]
    nb, B, m = A_t.shape
    n, dev = nb * B, A_t.device
    lam1s = torch.as_tensor(
        np.geomspace(0.95, 0.1 if group else 0.01, L) * d["lmax"],
        dtype=torch.float32, device=dev)
    rm = d["rm"] if masked else None
    keep = d["keep"] if masked else None
    R0 = (-(b if rm is None else rm * b))[None, :].expand(L, m).contiguous()
    X0 = torch.zeros(nb, L, B, device=dev)

    def pen_of(blocks: int):
        if not group:
            return l1(1.0)
        ng = blocks * B // C4_GSIZE
        return group_l2(1.0, ng, d["w"][:ng])

    def args_of(blocks: int) -> tuple:
        k = None if keep is None else keep[:blocks * B]
        return (A_t[:blocks], X0[:blocks], R0, steps[:blocks], lam1s, 0.0,
                pen_of(blocks), k, rm)

    # check: the whole sweep at config 2, the first 16 blocks at config 4
    cb = 16 if group else nb
    tol = 1e-4 if cb > 64 else 1e-5
    ca = args_of(cb)
    Xk, Rk = kb.batch_sweep_t(*ca)
    Xp, Rp = kb.batch_sweep_t_plain(*ca)
    if not float(Xp.abs().max()) > 0:
        raise SystemExit("time_sweep_batch: X stayed 0")
    err = cs.sweep_err("time_sweep_batch", "K5", Xk, Rk, Xp, Rp, tol)
    if not torch.equal(Xk, kb.batch_sweep_t(*ca)[0]):
        raise SystemExit("time_sweep_batch: two launches differ")
    a = args_of(nb)
    ms = cs.time_ms(lambda: kb.batch_sweep_t(*a), REPS)
    ng = n // C4_GSIZE if group else 0
    st: dict = {}
    cs.record(st, "k5", err, ms, None, None,
              (4 * m * n + 4 * L * (2 * n + 2 * m) + 4 * (L + nb + ng)
               + (n if masked else 0) + (4 * m if masked else 0),
               4 * m * n * L))
    out = {"L": L, "penalty": "group_l2" if group else "l1",
           "masked": masked, "ms": ms, "us_per_block": 1e3 * ms / nb,
           "bound_ms": st["k5"]["bound_ms"],
           "bound_by": st["k5"]["bound_by"], "max_abs_err": err,
           "trace_us": trace_us(lambda: kb.batch_sweep_t(*a), 5)}
    if hasattr(kb, "batch_plan"):
        plan = kb.batch_plan(dev, B, m, L, C4_GSIZE if group else 0)
        out["plan"] = dataclasses.asdict(plan) | {
            "smem_bytes": plan.smem_bytes}
    return out


if __name__ == "__main__":
    main()
