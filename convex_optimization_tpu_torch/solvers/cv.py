"""K-fold cross-validation over the lambda path: solve the grid on each
fold's training rows, score held-out mean squared error, pick lambda.

Counterpart of ``convex_optimization_tpu/solvers/cv.py``:
  * folds are ROW MASKS: the fold-f training problem is the original with
    its validation rows zeroed (rm * A, rm * b), exactly the lasso on the
    training subset with every shape unchanged;
  * with ``method='bcd_batch'`` (the default) the masks ride the batched
    kernels' residual rows (K5 gates its residual updates with the mask),
    so every fold path shares the one A_t and one set-up (K4) with the
    refit; the validation error is one K6 pass per chunk of path points;
  * the grid comes from the full data (lam_max through K3), and fold f
    solves at lambda * (m_train / m), because the data-fit term
    0.5 ||A x - b||^2 is not normalised by the row count.

Any other method, or a failed batched gate, runs per-fold masked copies of
A through the sequential path.  The JAX package's ``free_A`` option does
not carry over: here A is a view of A_t, so there is nothing to free.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import lambda_max_t
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    ax_minus_b_batch_t,
    blocks_of,
)
from convex_optimization_tpu_torch.solvers.batched_path import (
    batched_lambda_path,
    chunk_size,
    prepare_batched_solver,
)
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.lambda_path import (
    lambda_path,
    path_grid,
)


class CVResult(NamedTuple):
    lambdas: torch.Tensor       # (L,) shared grid (from the FULL data)
    val_mse: torch.Tensor       # (k, L) per-fold held-out mean squared error
    mean_mse: torch.Tensor      # (L,) mean across folds
    se_mse: torch.Tensor        # (L,) standard error across folds
    best_index: int             # argmin of mean_mse
    best_lambda: float
    one_se_index: int           # largest lambda within 1 SE of the minimum
    one_se_lambda: float        # (the sparser "1-SE rule" choice)
    x: torch.Tensor | None      # full-data refit at best_lambda (None
                                # with refit=False)
    x_one_se: torch.Tensor | None   # full-data refit at one_se_lambda
    method_used: str = "bcd_batch"  # solver that actually ran the folds
    fold_sweeps: tuple = ()     # sweeps each fold's path ran (not in the
                                # JAX package)


def kfold_train_masks(m: int, k: int, seed: int = 0) -> np.ndarray:
    """(k, m) float32 train masks: mask[f, i] == 0 iff row i is fold f's
    validation row.  Every row is a validation row in exactly one fold;
    the permutation is deterministic in ``seed`` (the JAX package's)."""
    if not 2 <= k <= m:
        raise ValueError(f"need 2 <= k <= m, got k={k}, m={m}")
    perm = np.random.default_rng(seed).permutation(m)
    masks = np.ones((k, m), np.float32)
    for f in range(k):
        masks[f, perm[f::k]] = 0.0
    return masks


def fold_lambda_scale(mask: np.ndarray) -> float:
    """m_train / m: the factor that makes a fold's lambda comparable to the
    full-data lambda at the same grid point under the unnormalised
    data-fit 0.5 ||A x - b||^2."""
    return float(np.sum(mask)) / mask.shape[-1]


def _val_mse_kernel(A_t: torch.Tensor, X: torch.Tensor, b: torch.Tensor,
                    val_mask: torch.Tensor) -> torch.Tensor:
    """Held-out MSE of a chunk of path points X (n_blocks, Lc, B): one K6
    pass computes R = A X - b for every point, masked to the fold's
    validation rows."""
    R = ax_minus_b_batch_t(A_t, X, b)
    return (val_mask[None, :] * R * R).sum(dim=1) / val_mask.sum()


def _val_mse(A_t: torch.Tensor, xs: torch.Tensor, b: torch.Tensor,
             val_mask: torch.Tensor) -> torch.Tensor:
    """Held-out MSE of path solutions xs (L, n), in the batched path's
    chunks."""
    nb = A_t.shape[0]
    L = xs.shape[0]
    chunk = chunk_size(L)
    return torch.cat([
        _val_mse_kernel(A_t, blocks_of(xs[c0:c0 + chunk], nb), b, val_mask)
        for c0 in range(0, L, chunk)])


def cv_lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    k: int = 5,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: torch.Tensor | None = None,
    seed: int = 0,
    method: str = "bcd_batch",
    refit: bool = True,
) -> CVResult:
    """K-fold CV over a warm-started lambda path; picks lambda by held-out
    MSE.

    Returns the MSE-minimising lambda and the "1-SE rule" lambda (the
    largest lambda whose mean MSE is within one standard error of the
    minimum) and, with ``refit=True``, the full-data refit along the grid
    at both of them (``x`` and ``x_one_se``; None with ``refit=False``)."""
    if lambdas is not None:
        lambdas = torch.as_tensor(lambdas, dtype=problem.dtype,
                                  device=problem.device)
    masks = kfold_train_masks(problem.m, k, seed)
    scales = [fold_lambda_scale(masks[f]) for f in range(k)]

    prep = None
    if method == "bcd_batch":
        val_mse, method_used, prep, lambdas, fold_sweeps = \
            _cv_folds_kernel_routed(problem, cfg, lambdas, masks, scales,
                                    lam_min_frac=lam_min_frac,
                                    path_len=path_len)
    else:
        lambdas = _full_grid(problem, lambdas, lam_min_frac, path_len)
        val_mse, fold_sweeps = _cv_folds_masked_copy(
            problem, cfg, lambdas, masks, scales, method)
        method_used = method
    mean_mse = val_mse.mean(dim=0)
    se_mse = val_mse.std(dim=0, correction=1) / math.sqrt(k)

    best = int(torch.argmin(mean_mse))
    thresh = mean_mse[best] + se_mse[best]
    # lambdas descend: the first index within the threshold is the largest
    one_se = int(torch.argmax((mean_mse <= thresh).to(torch.int32)))

    x = x_one_se = None
    if refit:
        if prep is not None:
            pr_full = batched_lambda_path(problem, cfg, lambdas=lambdas,
                                          prepared=prep)
        else:
            # a failed batched gate already warned: go straight to the
            # substituted solver
            refit_method = "bcd_pallas" if method == "bcd_batch" else method
            pr_full = lambda_path(problem, cfg, lambdas=lambdas,
                                  method=refit_method)
        x, x_one_se = pr_full.xs[best], pr_full.xs[one_se]

    lam_host = lambdas.tolist()
    return CVResult(
        lambdas=lambdas, val_mse=val_mse, mean_mse=mean_mse, se_mse=se_mse,
        best_index=best, best_lambda=lam_host[best],
        one_se_index=one_se, one_se_lambda=lam_host[one_se],
        x=x, x_one_se=x_one_se,
        method_used=method_used,
        fold_sweeps=tuple(fold_sweeps))


def _full_grid(problem: Problem, lambdas, lam_min_frac: float,
               path_len: int) -> torch.Tensor:
    """The default grid from the FULL data (lam_max through K3)."""
    if lambdas is None:
        lmax = float(lambda_max_t(problem.A_t, problem.b, problem.penalty))
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                            problem.device)
    return lambdas


def _cv_folds_kernel_routed(problem: Problem, cfg: SolverConfig, lambdas,
                            masks: np.ndarray, scales: list, *,
                            lam_min_frac: float, path_len: int):
    """All k fold paths through the batched kernels on one set-up.
    Returns (val_mse, method_used, prepared or None, lambdas,
    fold_sweeps); the refit reuses the prepared solver.  Falls back to
    the masked-copy route, with a warning, when the gate fails."""
    L = path_len if lambdas is None else lambdas.shape[0]
    k = masks.shape[0]
    prep = prepare_batched_solver(problem, cfg, chunk=chunk_size(L))
    if prep.reason is not None:
        warnings.warn(
            f"bcd_batch gate failed ({prep.reason}); CV falling back to "
            f"per-fold masked copies with the sequential bcd_pallas path",
            stacklevel=3)
        lambdas = _full_grid(problem, lambdas, lam_min_frac, path_len)
        val_mse, fold_sweeps = _cv_folds_masked_copy(
            problem, cfg, lambdas, masks, scales, "bcd_pallas")
        return (val_mse, "bcd_pallas+masked_copy", None, lambdas,
                fold_sweeps)

    lambdas = _full_grid(problem, lambdas, lam_min_frac, path_len)
    val_rows, fold_sweeps = [], []
    for f in range(k):
        tm = torch.as_tensor(masks[f], device=problem.device)
        pr = batched_lambda_path(problem, cfg, lambdas=lambdas * scales[f],
                                 row_mask=tm, prepared=prep, certify=False)
        val_rows.append(_val_mse(prep.A_t, pr.xs, problem.b, 1.0 - tm))
        fold_sweeps.append(pr.sweeps)
    return torch.stack(val_rows), "bcd_batch", prep, lambdas, fold_sweeps


def _cv_folds_masked_copy(problem: Problem, cfg: SolverConfig,
                          lambdas: torch.Tensor, masks: np.ndarray,
                          scales: list, method: str):
    """Per-fold masked copies of (A_t, b) through ``lambda_path``: the
    route for methods other than 'bcd_batch'.  Returns (val_mse,
    fold_sweeps)."""
    val_rows, fold_sweeps = [], []
    for f in range(masks.shape[0]):
        tm = torch.as_tensor(masks[f], device=problem.device)
        p_f = dataclasses.replace(problem, A_t=problem.A_t * tm,
                                  b=problem.b * tm)
        pr = lambda_path(p_f, cfg, lambdas=lambdas * scales[f],
                         method=method)
        val_rows.append(_val_mse(problem.A_t, pr.xs, problem.b, 1.0 - tm))
        fold_sweeps.append(pr.sweeps)
    return torch.stack(val_rows), fold_sweeps
