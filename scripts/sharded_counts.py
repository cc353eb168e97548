#!/usr/bin/env python3
"""chip_smoke.py's small sharded runs (phase 10: 500 x 2000, SHARD_P gloo
ranks, psum consensus; the BCD, l1 and weighted group_l2, and FISTA, l1)
with b as given and with one entry of b moved up by one ulp, on the card
(K8; K2 and K3 for FISTA) and on the CPU (the plain versions), for one
source tree, and the verdict of `path_check` on each card run against the
CPU run of the same input, method and penalty.

    python3 scripts/sharded_counts.py [--root DIR] [--where card,cpu]
                                      [--nudges -1,0,1,2,3,7]

Nudge -1 is b as given.  Imports `convex_optimization_tpu_torch` from DIR
(default: this checkout) and the instance, the solver settings and
`path_check` from this checkout's `chip_smoke.py`, so that a commit and
its parent unpacked beside it run the same instances and the same check
in turn.  One JSON line per (where, method, penalty, nudge): the steps,
the final f32 rel_gap, the f32 rel_gap at every check, and the kernels'
launches (none on the CPU); then, with both wheres, one line per (method,
penalty, nudge) with `path_check`'s failures (none: it passes) and what it
compared (`path_numbers`: the largest primal difference, the largest
rel_gap ratio, the crossing shifts and the last decade's shift in checks),
and a last line with the verdicts' count.  Needs a CUDA card for `--where card`; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runs_of(cs, pens) -> list:
    """(method, penalty, solver settings) of phase 10's small runs."""
    return [("bcd_pallas", kind, cs.SHARD_BCD) for kind in pens] + [
        ("fista", "l1", cs.SHARD_FISTA)]


def job(g, A_s, b_s, pens, nudges, runs):
    """In each rank: the sharded run of every (method, penalty, nudge)."""
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.problem import problem_from_numpy
    from convex_optimization_tpu_torch.ops import _build

    out = []
    for method, kind, kw in runs:
        for i in nudges:
            p = problem_from_numpy(A_s, nudged(b_s, i), device="cpu",
                                   **pens[kind])
            _build.reset_launches()
            res = cot.solve(p, method, mesh=g, consensus="psum", **kw)
            out.append(dict(method=method, penalty=kind, nudge=i,
                            k=res.iterations,
                            best_rel_gap=res.rel_gap,
                            rel_gap=res.history["rel_gap"].tolist(),
                            primal=res.history["primal"].tolist(),
                            converged=bool(res.converged),
                            x=res.x.cpu().numpy(),
                            launches=dict(_build.launches)))
    return out


def nudged(b, i: int):
    """b with b[i] one ulp up (i >= 0), else b as given."""
    import numpy as np

    b = b.copy()
    if i >= 0:
        b[i] = np.nextafter(b[i], np.float32(np.inf))
    return b


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--where", default="card,cpu")
    ap.add_argument("--nudges", default="-1,0,1,2,3,7")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.parallel.launch import run_ranks

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    A_s, b_s, pens = cs.shard_small_instance()
    nudges = [int(v) for v in args.nudges.split(",")]
    card = None
    if "card" in args.where:
        from convex_optimization_tpu_torch.ops import _build

        _build.load()                # once, before the ranks start
        card = cs.card_line()
    runs = {}
    for where in args.where.split(","):
        device = "cuda:0" if where == "card" else "cpu"
        with tempfile.TemporaryDirectory() as tmp:
            ranks = run_ranks(job, cs.SHARD_P, tmp, A_s, b_s, pens, nudges,
                              runs_of(cs, pens), device=device,
                              backend="gloo", timeout_s=900)
        for rank in ranks[1:]:
            if [r["k"] for r in rank] != [r["k"] for r in ranks[0]]:
                raise SystemExit("sharded_counts: the ranks disagree")
        for row in ranks[0]:
            runs[(where, row["method"], row["penalty"], row["nudge"])] = row
            line = {k: v for k, v in row.items() if k not in ("x", "primal")}
            print(json.dumps({"root": root, "where": where, **line,
                              "card": card}), flush=True)
    if {"card", "cpu"} <= set(args.where.split(",")):
        passed = 0
        for method, kind, kw in runs_of(cs, pens):
            tol = kw["tol"]
            for i in nudges:
                b = nudged(b_s, i)
                p = cot.problem_from_numpy(A_s, b, device="cpu", **pens[kind])
                # polished to 1e-6, as phase 10 polishes every small run
                held = [cs.path_run(p, runs[(w, method, kind, i)], A_s, b,
                                    1e-6) for w in ("card", "cpu")]
                fails = cs.path_check(*held, tol, kw["gap_every"])
                passed += not fails
                print(json.dumps({
                    "root": root, "path_check": f"{method}/{kind}",
                    "nudge": i, "steps": [h["k"] for h in held],
                    "f64_rel_gap_unpolished": [h["f64_rel_gap"]
                                               for h in held],
                    **cs.path_numbers(*held, tol), "failures": fails,
                    "card": card}), flush=True)
        print(json.dumps({"root": root, "path_check_passed": passed,
                          "of": len(runs_of(cs, pens)) * len(nudges),
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
