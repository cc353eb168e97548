#!/usr/bin/env python3
"""The eigendecomposition behind ADMM's set-up (``solvers/admm.py``),
three ways, at the small-side Gram sizes of config 2 (k = 5000) and the
headline (k = 10 000): ``numpy.linalg.eigh`` in float64 on the host (what
``admm_setup_host`` runs), ``torch.linalg.eigh`` in float64 on the host,
and ``torch.linalg.eigh`` in float64 on the card (the candidate that would
lift the 4096 fence on the card, ROADMAP queue 1).

    python3 scripts/time_eigh.py [--sizes 5000,10000]

Each Gram is G = X X^T of a seeded Gaussian X (k x 2k, float32 as the
solver's A, the product in float64), so it is well conditioned like the
instances' A A^T.  Prints one JSON line per size with each route's wall
seconds, the largest eigenvalue difference between the host and card
routes relative to the largest eigenvalue, and the card's name and power
limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="5000,10000")
    args = ap.parse_args()
    import numpy as np
    import torch

    from chip_smoke import card_line

    if not torch.cuda.is_available():
        raise SystemExit("time_eigh: no CUDA device is available")
    gpu, power = [s.strip() for s in card_line().split(",", 1)]
    dev = torch.device("cuda", 0)
    # the card's solver library initialises on its first call
    torch.linalg.eigh(torch.eye(8, dtype=torch.float64, device=dev))
    for k in (int(v) for v in args.sizes.split(",")):
        X = np.random.default_rng(0).standard_normal(
            (k, 2 * k)).astype(np.float32).astype(np.float64)
        G = X @ X.T
        del X
        t0 = time.perf_counter()
        s_np, _ = np.linalg.eigh(G)
        numpy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.linalg.eigh(torch.from_numpy(G))
        torch_cpu_s = time.perf_counter() - t0
        Gd = torch.from_numpy(G).to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        s_d, _ = torch.linalg.eigh(Gd)
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t0
        err = float(np.abs(s_d.cpu().numpy() - s_np).max() / s_np.max())
        print(json.dumps({"metric": f"eigh_f64_{k}x{k}",
                          "numpy_host_s": numpy_s,
                          "torch_host_s": torch_cpu_s,
                          "torch_card_s": card_s,
                          "host_threads": torch.get_num_threads(),
                          "eigenvalue_rel_diff": err,
                          "gpu": gpu, "power_limit": power}), flush=True)
        del G, Gd


if __name__ == "__main__":
    main()
