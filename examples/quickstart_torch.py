"""Quickstart for the PyTorch/CUDA port: generate a lasso instance, solve
it with a certificate, run a warm-started lambda path and pick lambda by
cross-validation.

    python examples/quickstart_torch.py               # on the card
    python examples/quickstart_torch.py --device cpu  # anywhere
    python examples/quickstart_torch.py --small --device cpu

See README.md for the full API.
"""

import argparse
import os
import sys

# run from a checkout without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import convex_optimization_tpu_torch as cot  # noqa: E402
from convex_optimization_tpu_torch.solvers.common import (  # noqa: E402
    SolverConfig,
)


def main(small: bool = False, device: str = "cuda") -> None:
    # synthetic problem: dense Gaussian A, planted 5% support, small noise
    # (--small: CI-twin sizes so the smoke test stays cheap)
    m, n, path_len, k = (96, 384, 4, 3) if small else (400, 1600, 8, 5)
    dev = cot.require_cuda() if device == "cuda" else torch.device(device)
    gen = torch.Generator().manual_seed(0)
    inst = cot.datagen.make_lasso_instance(gen, m, n, noise_std=0.02,
                                           device=dev)
    problem = inst.problem

    # 1. one solve; certify=True finishes with the f64 polish when the f32
    #    monitor stops above tol (the 1e-6 grade is an f64-certified
    #    duality gap)
    res = cot.solve(problem, method="fista", tol=1e-6, max_iters=5000,
                    stall_checks=15, certify=True)
    rec = int(((res.x != 0) & inst.support).sum()) / int(inst.support.sum())
    print(f"fista: rel_gap={res.rel_gap:.2e} converged={res.converged} "
          f"nnz={res.nnz} support-recall={rec:.2f} "
          f"({res.iters_per_sec:.0f} it/s)")

    # 2. a warm-started lambda path; method='bcd_batch' solves every point
    #    against one shared read of A
    cfg = SolverConfig(tol=1e-6, max_iters=5000, stall_checks=15)
    path = cot.lambda_path(problem, cfg, path_len=path_len,
                           method="bcd_batch")
    print("path:  " + "  ".join(
        f"lam={float(lam):.3g}:nnz={int((x != 0).sum())}"
        for lam, x in zip(path.lambdas, path.xs)))

    # 3. pick lambda by K-fold cross-validation (min-MSE and 1-SE rule)
    cv = cot.cv_lambda_path(problem, cfg, k=k, path_len=path_len)
    print(f"cv:    best_lambda={cv.best_lambda:.4g} "
          f"(mse={float(cv.mean_mse[cv.best_index]):.4g}), "
          f"1-SE lambda={cv.one_se_lambda:.4g}, "
          f"nnz@best={int((cv.x != 0).sum())}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args()
    main(small=a.small, device=a.device)
