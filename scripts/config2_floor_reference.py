#!/usr/bin/env python3
"""Config 2's f32 floor at seeds 1 and 3, against the JAX package.

On the card, config 2's 10-point bcd_batch lambda path (5k x 50k, tol
1e-6, gap_every 10, stall_checks 10) ends with its last point (0.01
lam_max) above the 1e-4 f64 floor at seeds 1 and 3.  This script looks for
the same floor on the CPU at shapes of config 2's aspect (n = 10 m): the
port's bcd_batch path (plain versions of K5-K7) at each shape and seed,
then, where the port's last points end above the floor and ``--jax`` is
given, the JAX package's batched path (its Pallas kernels in interpret
mode) on the same arrays.  Every f64 gap is the port's
``duality_gap(precise=True)``, for both packages' iterates.

    JAX_PLATFORMS=cpu python scripts/config2_floor_reference.py \\
        [--shapes 500x5000,1000x10000] [--seeds 0,1,3] [--jax]

Prints one JSON line per (package, shape, seed): sweeps, each point's
sweeps and f32 and f64 rel_gap, the largest f64 gap, whether it is above
the floor, and the wall.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PATH = dict(tol=1e-6, max_iters=10_000, gap_every=10, stall_checks=10,
            block_size=128)
PATH_LEN = 10
FLOOR = 1e-4                 # config 2's f64 floor at seed 0 (BASELINE.md:88)


def f64_gaps(tp, lambdas, xs) -> list:
    import torch

    import convex_optimization_tpu_torch as cot

    return [float(cot.duality_gap(tp.with_lam1(float(lam)),
                                  torch.as_tensor(x), precise=True).rel_gap)
            for lam, x in zip(lambdas, xs)]


def report(package, m, n, seed, iters, f32, f64, sweeps, wall) -> bool:
    above = max(f64) > FLOOR
    print(json.dumps({
        "package": package, "m": m, "n": n, "seed": seed, "sweeps": sweeps,
        "iters": [int(k) for k in iters],
        "f32_rel_gap": [float(g) for g in f32], "f64_rel_gap": f64,
        "max_f64_rel_gap": max(f64), "above_floor": above,
        "wall_s": wall}), flush=True)
    return above


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="500x5000,1000x10000")
    ap.add_argument("--seeds", default="0,1,3")
    ap.add_argument("--jax", action="store_true",
                    help="run the JAX package where the port shows the floor")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    torch.set_num_threads(args.threads)
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    for m, n in shapes:
        for seed in seeds:
            inst, _, _ = make_lasso_instance_host(seed, m, n, device="cpu")
            tp = inst.problem
            t0 = time.perf_counter()
            res = cot.lambda_path(tp, SolverConfig(**PATH),
                                  path_len=PATH_LEN, method="bcd_batch")
            wall = time.perf_counter() - t0
            lambdas = res.lambdas.tolist()
            above = report("torch_cpu_plain", m, n, seed, res.iters.tolist(),
                           res.gaps.tolist(),
                           f64_gaps(tp, lambdas, res.xs), res.sweeps, wall)
            if not (above and args.jax):
                continue
            import jax.numpy as jnp

            from convex_optimization_tpu.core.datagen import (
                make_lasso_instance_host as j_make_host,
            )
            from convex_optimization_tpu.solvers.batched_path import (
                batched_lambda_path,
            )
            from convex_optimization_tpu.solvers.common import (
                SolverConfig as JSolverConfig,
            )

            j_inst, _, _ = j_make_host(seed, m, n)
            t0 = time.perf_counter()
            jr = batched_lambda_path(j_inst.problem, JSolverConfig(**PATH),
                                     lambdas=jnp.asarray(lambdas,
                                                         jnp.float32),
                                     interpret=True)
            j_xs = np.asarray(jr.xs)
            wall = time.perf_counter() - t0
            j_iters = np.asarray(jr.iters)
            report("jax_interpret", m, n, seed, j_iters.tolist(),
                   np.asarray(jr.gaps).tolist(),
                   f64_gaps(tp, lambdas, j_xs), int(j_iters.max()), wall)


if __name__ == "__main__":
    main()
