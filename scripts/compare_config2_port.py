#!/usr/bin/env python3
"""Config 2 on the PyTorch port of one source tree: K6/K7 times and the
λ-path's sweep count at several seeds.

    python3 scripts/compare_config2_port.py [--root DIR] [--kernels]
                                            [--seeds 0,1,2]

Imports `convex_optimization_tpu_torch` from DIR (default: this checkout)
and `chip_smoke.py` from this checkout, so that two trees (a commit and its
parent unpacked beside it) run the same measurement in turn on one card.
With --kernels it runs `chip_smoke.compare_batch_matvecs` on config 2's
A_t as the smoke draws it: K6 and K7 against their plain versions and
timed beside `addmm` at L = 1, 4, 10, 16 (the tree's `ops.bcd_sweep_batch`
must have `matvec_batch_plan`).  Then, for each of --seeds, it draws config
2 (5k x 50k) with `make_lasso_instance_host(seed, ...)` and runs
`chip_smoke.config2_path`: the 10-point `lambda_path(method="bcd_batch")`
with the smoke's settings, one JSON line with sweeps, wall and every
point's f64 rel_gap.  Prints the kernel build's seconds and the card's
name and power limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_config2_port: needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    gpu, power = [s.strip() for s in cs.card_line().split(",", 1)]
    _build.load()
    print(json.dumps(dict(root=root, build_s=_build.build_seconds, gpu=gpu,
                          power_limit=power)), flush=True)
    device = torch.device("cuda", 0)
    # K6/K7 untimed unless --kernels: config2_path's checks share is NaN
    stats = {k: {"max_abs_err": 0.0, "ms": math.nan}
             for k in ("ax_minus_b_batch_t", "neg_at_r_batch_t")}
    if args.kernels:
        inst, _, _ = make_lasso_instance_host(cs.C2_SEED, cs.C2_M, cs.C2_N,
                                              device=device)
        gen = torch.Generator(device="cpu").manual_seed(cs.SEED + 1)
        for L in cs.MATVEC_LS:
            cs.compare_batch_matvecs(inst.problem.with_block(80).A_t,
                                     inst.problem.b, L, "config2", stats,
                                     gen, True, (gpu, power))
        del inst
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        inst, _, _ = make_lasso_instance_host(seed, cs.C2_M, cs.C2_N,
                                              device=device)
        problem = inst.problem
        print(json.dumps(dict(root=root, seed=seed)), flush=True)
        try:
            cs.config2_path(problem, gpu, power, stats)
        except SystemExit as e:   # a failed check, after its JSON line
            print(json.dumps(dict(root=root, seed=seed, failed=str(e))),
                  flush=True)
        del inst, problem
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
