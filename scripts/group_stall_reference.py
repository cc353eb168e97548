#!/usr/bin/env python3
"""The JAX package on the 4096 x 4000 group lasso that chip_smoke.py's
small group reference solves (40 groups of 100, lam1 = 0.05 lam_max):
solve(bcd_pallas, tol=1e-6, gap_every=10, stall_checks=15) at block_size
200 and 2000, its Pallas kernels in interpret mode on the CPU (its K3 sums
in f32, as the PyTorch port's K3 does on the card), and the port on the
CPU (plain versions; the plain K3 sums in f64) on the same arrays.

    JAX_PLATFORMS=cpu python scripts/group_stall_reference.py

Prints one JSON line per (package, block_size) with the sweep count, the
best f32 rel_gap and whether the run ended on the stall rule.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SOLVE = dict(tol=1e-6, max_iters=20_000, gap_every=10, stall_checks=15)
INSTANCE = dict(penalty_kind="group_l2", ngroups=40, lam1_frac=0.05)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import convex_optimization_tpu as co
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu.core.datagen import (
        make_lasso_instance_host,
    )

    inst, A, b = make_lasso_instance_host(4, 4096, 4000, **INSTANCE)
    pen = inst.problem.penalty
    tp = cot.problem_from_numpy(A, b, "group_l2", float(pen.lam1),
                                ngroups=40, device="cpu")
    for bs in (200, 2000):
        for name, run in (
                ("jax_interpret", lambda: co.solve(inst.problem, "bcd_pallas",
                                                   block_size=bs, **SOLVE)),
                ("torch_cpu_plain", lambda: cot.solve(tp, "bcd_pallas",
                                                      block_size=bs,
                                                      **SOLVE))):
            t0 = time.perf_counter()
            res = run()
            rel = [float(v) for v in res.history["rel_gap"]]
            print(json.dumps({
                "package": name, "block_size": bs,
                "sweeps": int(res.iterations),
                "best_f32_rel_gap": float(res.rel_gap),
                "converged": bool(res.converged),
                "stalled": (not res.converged
                            and int(res.iterations) < SOLVE["max_iters"]),
                "last_rel_gaps": rel[-4:],
                "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
