"""Convergence plots: error against iteration, the lambda-path summary
and the CV curve.

Counterpart of ``convex_optimization_tpu/utils/plotting.py``.  matplotlib
is imported lazily with the Agg backend; every entry point returns False
(with a note on stderr) when it is missing, so the solvers never depend on
it.  Inputs may be arrays, lists or tensors on any device.
"""

from __future__ import annotations

import sys

import numpy as np


def _np(v, dtype=float) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=dtype)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception as e:
        print(f"plotting unavailable ({e}); skipping", file=sys.stderr)
        return None


def plot_history(history: dict, path: str, *, title: str = "") -> bool:
    """Error-vs-iteration curves from a Result.history dict (the trimmed
    per-check records): relative duality gap (log scale) and primal value.
    Returns True if the figure was written."""
    plt = _plt()
    if plt is None or "iteration" not in history:
        return False
    it = _np(history["iteration"])
    if it.size == 0:
        return False
    fig, ax1 = plt.subplots(figsize=(7, 4.2))
    rel = np.maximum(_np(history["rel_gap"]), 1e-300)
    ax1.semilogy(it, rel, "o-", color="tab:blue", ms=3,
                 label="relative duality gap")
    ax1.set_xlabel("iteration / sweep")
    ax1.set_ylabel("relative duality gap", color="tab:blue")
    ax1.grid(True, which="both", alpha=0.25)
    if "primal" in history:
        ax2 = ax1.twinx()
        ax2.plot(it, _np(history["primal"]), "s--",
                 color="tab:orange", ms=3, alpha=0.7, label="primal value")
        ax2.set_ylabel("primal objective", color="tab:orange")
    if title:
        ax1.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def plot_path(lambdas, gaps, iters, nnzs, path: str, *,
              title: str = "") -> bool:
    """Lambda-path summary: per-point final gap, iterations, and support
    size against lambda (log-x).  Returns True if written."""
    plt = _plt()
    if plt is None:
        return False
    lam = _np(lambdas)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
    axes[0].loglog(lam, np.maximum(_np(gaps), 1e-300),
                   "o-")
    axes[0].set_xlabel("lambda"); axes[0].set_ylabel("final rel gap")
    axes[1].semilogx(lam, _np(iters), "o-")
    axes[1].set_xlabel("lambda"); axes[1].set_ylabel("iterations")
    axes[2].semilogx(lam, _np(nnzs), "o-")
    axes[2].set_xlabel("lambda"); axes[2].set_ylabel("nnz")
    for ax in axes:
        ax.grid(True, which="both", alpha=0.25)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def plot_cv(lambdas, mean_mse, se_mse, best_lambda, one_se_lambda,
            path: str, *, title: str = "") -> bool:
    """CV curve: mean held-out MSE ± 1 SE against lambda (log-x), with the
    MSE-minimizing and 1-SE-rule choices marked.  Returns True if written."""
    plt = _plt()
    if plt is None:
        return False
    lam = _np(lambdas)
    mu = _np(mean_mse)
    se = _np(se_mse)
    fig, ax = plt.subplots(figsize=(7, 4.2))
    ax.errorbar(lam, mu, yerr=se, fmt="o-", ms=4, capsize=3,
                color="tab:blue", ecolor="tab:blue", alpha=0.85,
                label="held-out MSE (mean ± 1 SE)")
    ax.set_xscale("log")
    ax.axvline(best_lambda, color="tab:green", ls="--",
               label=f"min MSE (λ={best_lambda:.3g})")
    if one_se_lambda != best_lambda:
        ax.axvline(one_se_lambda, color="tab:orange", ls=":",
                   label=f"1-SE rule (λ={one_se_lambda:.3g})")
    ax.set_xlabel("lambda")
    ax.set_ylabel("validation MSE")
    ax.grid(True, which="both", alpha=0.25)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
