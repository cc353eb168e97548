#!/usr/bin/env python3
"""Step counts of chip_smoke.py's small sharded BCD (phase 10: 500 x 2000,
SHARD_P gloo ranks, psum consensus, l1 and weighted group_l2) with b as
given and with one entry of b moved up by one ulp, on the card (K8) and on
the CPU (the plain version), for one source tree.

    python3 scripts/sharded_counts.py [--root DIR] [--where card,cpu]
                                      [--nudges -1,0,1,2,3,7]

Nudge -1 is b as given.  Imports `convex_optimization_tpu_torch` from DIR
(default: this checkout) and the instance's constants from this checkout's
`chip_smoke.py`, so that a commit and its parent unpacked beside it run the
same instances in turn.  One JSON line per (where, penalty, nudge): the
steps, the final f32 rel_gap, the f32 rel_gap at every check, and the
sweep kernels' launches (K8 on the card; none on the CPU).  What it shows:
how far the step count moves under rounding alone, the reference's and
each kernel's, beside the one-check margin the smoke holds the card to.
Needs a CUDA card for `--where card`; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def job(g, A_s, b_s, pens, nudges):
    """In each rank: the sharded BCD of every (penalty, nudge)."""
    import numpy as np

    import chip_smoke as cs
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.problem import problem_from_numpy
    from convex_optimization_tpu_torch.ops import _build

    out = []
    for kind, pen in pens.items():
        for i in nudges:
            b = b_s.copy()
            if i >= 0:
                b[i] = np.nextafter(b[i], np.float32(np.inf))
            p = problem_from_numpy(A_s, b, device="cpu", **pen)
            _build.reset_launches()
            res = cot.solve(p, "bcd_pallas", mesh=g, consensus="psum",
                            **cs.SHARD_BCD)
            out.append(dict(penalty=kind, nudge=i, k=res.iterations,
                            rel_gap=res.rel_gap,
                            rel_gaps=res.history["rel_gap"].tolist(),
                            launches=dict(_build.launches)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--where", default="card,cpu")
    ap.add_argument("--nudges", default="-1,0,1,2,3,7")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke as cs          # this checkout's, whatever --root is

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.parallel.launch import run_ranks

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    small, A_s, b_s = make_lasso_instance_host(*cs.SHARD_SMALL, device="cpu")
    w_s = np.random.default_rng(cs.SHARD_SMALL[0]).uniform(
        0.5, 1.5, cs.SHARD_GROUPS).astype(np.float32)
    g_norms = np.linalg.norm((A_s.T @ b_s).reshape(cs.SHARD_GROUPS, -1),
                             axis=1)
    pens = {"l1": dict(penalty_kind="l1",
                       lam1=float(small.problem.penalty.lam1)),
            "group_l2": dict(penalty_kind="group_l2",
                             ngroups=cs.SHARD_GROUPS, weights=w_s,
                             lam1=float(0.1 * (g_norms / w_s).max()))}
    nudges = [int(v) for v in args.nudges.split(",")]
    card = None
    if "card" in args.where:
        from convex_optimization_tpu_torch.ops import _build

        _build.load()                # once, before the ranks start
        card = cs.card_line()
    for where in args.where.split(","):
        device = "cuda:0" if where == "card" else "cpu"
        with tempfile.TemporaryDirectory() as tmp:
            ranks = run_ranks(job, cs.SHARD_P, tmp, A_s, b_s, pens, nudges,
                              device=device, backend="gloo", timeout_s=900)
        for rank in ranks[1:]:
            if [r["k"] for r in rank] != [r["k"] for r in ranks[0]]:
                raise SystemExit("sharded_counts: the ranks disagree")
        for row in ranks[0]:
            print(json.dumps({"root": root, "where": where, **row,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
