#!/usr/bin/env python3
"""K10 (`ops/cd64.cd64_sweeps_t`), the f64 polish's coordinate descent on
the card, at the headline's support (m = 10 000 rows, k columns), beside
the host's native sweeps on the same columns and the bound.

    python3 scripts/time_cd64.py [--k 6000,7000] [--blocks 128,96,64]

For each k: a random unit-column support slab (a seeded device generator),
b = A x* + noise and lam1 = 0.1 max|A^T b|; K10 at every block width given
(the plan's widest first), checked against the host's `native.cd64_sweeps`
after 4 sweeps from x = 0 (x to 1e-10 relative), then timed with CUDA
events over 5 launches of 2 sweeps (the polish's `gap_every`), beside the
check's two products (`cd64_residual_t`, `cd64_atr_t`), the Gram's set-up
(`block_gram64`) and one host sweep.  Bound: the slab's bytes, 4 k m a
sweep, at 3.35 TB/s.  Prints one JSON line per (k, B) with the card's name
and power limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 10_000
REPS = 5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", default="6000,7000")
    ap.add_argument("--blocks", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_cd64: needs a CUDA card")
    sys.path.insert(0, HERE)
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.ops import cd64 as K
    from convex_optimization_tpu_torch.utils import native

    _build.load()
    dev = torch.device("cuda", 0)
    card = _card()
    plan = K.cd64_plan(dev, M)
    blocks = ([int(v) for v in args.blocks.split(",")] if args.blocks
              else [plan.B])
    for k in (int(v) for v in args.k.split(",")):
        gen = torch.Generator(device=dev).manual_seed(k)
        A = torch.randn(k, M, generator=gen, device=dev)
        A /= torch.linalg.vector_norm(A, dim=1, keepdim=True)
        xt = torch.where(torch.rand(k, generator=gen, device=dev) < 0.5,
                         torch.randn(k, generator=gen, device=dev), 0.0)
        b64 = (A.double().T @ xt.double()
               + 0.01 * torch.randn(M, generator=gen, device=dev).double())
        lam1 = 0.1 * float((A.double() @ b64).abs().max())
        A_host = np.asfortranarray(A.cpu().numpy().T)
        b_host = b64.cpu().numpy()
        col_sq_h = np.einsum("ij,ij->j", A_host, A_host, dtype=np.float64)
        xh = np.zeros(k)
        rh = -b_host.copy()
        t0 = time.perf_counter()
        native.cd64_sweeps(A_host, xh, rh, col_sq_h, lam1, 0.0, False, 1)
        host_sweep_s = time.perf_counter() - t0
        native.cd64_sweeps(A_host, xh, rh, col_sq_h, lam1, 0.0, False, 3)
        for B in blocks:
            slab = K.support_slab(A, torch.arange(k, device=dev), B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gram = K.block_gram64(slab, B)
            torch.cuda.synchronize()
            gram_ms = 1e3 * (time.perf_counter() - t0)
            col_sq = torch.diagonal(gram, dim1=1, dim2=2).reshape(-1).clone()
            col_sq[k:] = 1.0
            x = torch.zeros((slab.shape[0],), dtype=torch.float64,
                            device=dev)
            r = K.cd64_residual_t(slab, x, b64)
            K.cd64_sweeps_t(slab, x, r, col_sq, gram, lam1, 0.0, False, 4)
            xc = x[:k].cpu().numpy()
            err = float(np.abs(xc - xh).max() / np.abs(xh).max())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            for _ in range(REPS):
                K.cd64_sweeps_t(slab, x, r, col_sq, gram, lam1, 0.0, False,
                                2)
            ev[1].record()
            for _ in range(REPS):
                K.cd64_residual_t(slab, x, b64)
            ev[2].record()
            for _ in range(REPS):
                K.cd64_atr_t(slab, r, x, 0.0)
            ev[3].record()
            torch.cuda.synchronize()
            sweep_ms = ev[0].elapsed_time(ev[1]) / (2 * REPS)
            nblk = slab.shape[0] // B
            print(json.dumps({
                "card": card, "k": k, "m": M, "B": B, "blocks": nblk,
                "plan": vars(K.cd64_plan(dev, M)),
                "x_rel_err_vs_host_4_sweeps": err,
                "ms_per_sweep": round(sweep_ms, 4),
                "us_per_block": round(1e3 * sweep_ms / nblk, 3),
                "ns_per_coordinate": round(1e6 * sweep_ms / k, 1),
                "bound_ms": round(4 * k * M / 3.35e9, 4),
                "residual_ms": round(ev[1].elapsed_time(ev[2]) / REPS, 4),
                "atr_ms": round(ev[2].elapsed_time(ev[3]) / REPS, 4),
                "gram_ms": round(gram_ms, 3),
                "host_ms_per_sweep": round(1e3 * host_sweep_s, 2),
            }), flush=True)
            del slab, gram


if __name__ == "__main__":
    main()
