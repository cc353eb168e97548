#!/usr/bin/env python3
"""K2 (`ax_minus_b_t`) and K3 (`neg_at_r_t`) of one source tree on the
card, at the headline's A_t (1250 x 80 x 10000) and config 2's (625 x 80 x
5000), beside `torch.addmv` computing the same function and the bound.

    python3 scripts/time_matvec.py [--root DIR]

Imports `convex_optimization_tpu_torch` from DIR (default: this checkout)
and `chip_smoke.py` from this checkout, so that two trees (a commit and its
parent unpacked beside it) run the same measurement in turn on one card.
A_t, x and b are random (a seeded device generator, columns of unit
norm); each call is checked against its plain version (K2 to 1e-5 of
||x|| ||A||_F + max|b|, K3 to witness_gamma(m) ||A_j|| ||r||) and timed
with CUDA events over 20 launches.  On a tree that has
`ops/matvec.matvec_plan` (the redesigned K2 and K3) it also prints their
plan, times K6/K7, the batched kernels, at L = 1 on the same inputs, and
adds each CUDA kernel's mean device time per wrapper call from
`torch.profiler` (K2's partial pass and its finish apart).  Prints one
JSON line per (tree, shape) with the card's name and power limit.  Needs
a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"headline": (1250, 80, 10_000), "config2": (625, 80, 5_000)}
REPS = 20


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_matvec: needs a CUDA card")
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this checkout's, whatever --root is

    sys.path.insert(0, root)
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.ops import matvec as mv

    if not cot.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {cot.__file__}, not from {root}")
    gpu, power = [s.strip() for s in cs.card_line().split(",", 1)]
    _build.load()
    dev = torch.device("cuda", 0)
    for label, (nb, B, m) in SHAPES.items():
        n = nb * B
        gen = torch.Generator(device=dev).manual_seed(nb)
        A_t = torch.randn(nb, B, m, generator=gen, device=dev)
        A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
        x = torch.randn(n, generator=gen, device=dev)
        b = torch.randn(m, generator=gen, device=dev)
        zeros_n = torch.zeros(n, device=dev)
        A = A_t.view(n, m).T
        out = {"root": root, "shape": label, "A_t": [nb, B, m], "gpu": gpu,
               "power_limit": power,
               "bound_ms": 1e3 * 4 * m * n / cs.HBM_BYTES_PER_S}

        r = mv.ax_minus_b_t(A_t, x, b)
        scale = float(torch.linalg.vector_norm(x)) * float(
            torch.linalg.vector_norm(A_t)) + float(b.abs().max())
        err = float((r - mv.ax_minus_b_t_plain(A_t, x, b)).abs().max())
        if err > 1e-5 * scale:
            raise SystemExit(f"{label}: K2 err {err}")
        z = mv.neg_at_r_t(A_t, r, zeros_n, 0.0)
        err = float((z - mv.neg_at_r_t_plain(A_t, r, zeros_n, 0.0))
                    .abs().max())
        bound = mv.witness_gamma(m) * float(torch.linalg.vector_norm(r))
        if err > bound:
            raise SystemExit(f"{label}: K3 err {err} > {bound}")
        out["k2_ms"] = cs.time_ms(lambda: mv.ax_minus_b_t(A_t, x, b), REPS)
        out["k3_ms"] = cs.time_ms(
            lambda: mv.neg_at_r_t(A_t, r, zeros_n, 0.0), REPS)
        out["addmv_k2_ms"] = cs.time_ms(
            lambda: torch.addmv(b, A, x, beta=-1.0), REPS)
        out["addmv_k3_ms"] = cs.time_ms(
            lambda: torch.addmv(zeros_n, A.T, r, beta=0.0, alpha=-1.0), REPS)
        if hasattr(mv, "matvec_plan"):
            out.update(extras(cs, mv, A_t, x, b, r))
            out["k2_trace_us"] = trace_us(lambda: mv.ax_minus_b_t(A_t, x, b))
            out["k3_trace_us"] = trace_us(
                lambda: mv.neg_at_r_t(A_t, r, zeros_n, 0.0))
        print(json.dumps(out), flush=True)
        del A_t, A


def trace_us(fn, calls: int = 10) -> dict:
    """Mean device microseconds per call of each CUDA kernel that ``fn``
    launches, from torch.profiler over ``calls`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    got = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type.name == "CUDA":
            got[ev.key[:60]] = us / calls
    return got


def extras(cs, mv, A_t, x, b, r) -> dict:
    """K2's and K3's plan, and K6 and K7, the batched kernels, at L = 1 on
    the same inputs (the alternative of running K2 and K3 through them)."""
    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb

    nb, B, m = A_t.shape
    X = x.view(nb, 1, B)
    return {"plan": vars(mv.matvec_plan(A_t.device, nb * B, m)),
            "k6_L1_ms": cs.time_ms(lambda: kb.ax_minus_b_batch_t(A_t, X, b),
                                   REPS),
            "k7_L1_ms": cs.time_ms(
                lambda: kb.neg_at_r_batch_t(A_t, r.view(1, m), X, 0.0),
                REPS)}


if __name__ == "__main__":
    main()
