"""Warm-started lambda path.

Counterpart of ``convex_optimization_tpu/solvers/lambda_path.py`` for the
``fista`` (the default), ``ista``, ``bcd``, ``bcd_pallas`` and
``bcd_batch`` methods with ``compact=False``.  A geometric grid lam_max ->
lam_min_frac * lam_max is solved point by point, each solve warm-started
at the previous point's solution, or, with ``method='bcd_batch'``, all at
once (``solvers/batched_path.py``).

The FISTA path computes L_total = ||A||^2 + lam2 once (the K2/K3 power
iteration) and warm-starts each point at the previous point's LAST
iterate, returning the last iterates and their gaps, as the JAX package
does; 'ista' is the same path (the JAX package's sets no momentum=False,
so ``cfg.momentum`` decides).  The BCD paths hoist the per-block
Lipschitz constants (K4) once and warm-start at the previous point's best
iterate.  Every warm start's residual comes from K2, and the grid's
lam_max from the witness kernel K3 (``lambda_max_t``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import lambda_max_t
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    block_power_t_plain,
    spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers.common import (
    NOT_PORTED,
    SolverConfig,
)


class PathResult(NamedTuple):
    lambdas: torch.Tensor           # (path_len,)
    xs: torch.Tensor                # (path_len, n) solutions
    gaps: torch.Tensor              # (path_len,) best relative gaps
    iters: torch.Tensor             # (path_len,) sweeps at each point's
                                    # best (FISTA: steps at each point)
    method_used: str | None = None  # the solver that actually ran
    converged: torch.Tensor | None = None   # (path_len,) gaps <= tol
    sweeps: int = 0                 # sweeps (FISTA: steps) run in all
                                    # (not in the JAX package: the
                                    # batched path's iters are per point
                                    # and overlap)


def path_grid(lmax: float, path_len: int, lam_min_frac: float,
              dtype: torch.dtype, device) -> torch.Tensor:
    """Geometric grid 0.95 lam_max -> lam_min_frac lam_max (just below
    lam_max, where the solution is exactly 0), computed in f64."""
    g = np.geomspace(0.95 * lmax, lam_min_frac * lmax, path_len)
    return torch.as_tensor(g, dtype=dtype, device=device)


def lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: torch.Tensor | None = None,
    compact: bool = False,
    mesh=None,
    method: str = "fista",
) -> PathResult:
    """Warm-started path on the device of ``problem.A_t``.

    method: 'fista' (the default, as in the JAX package: K2/K3 steps) or
    'ista', 'bcd_batch' (every point at once through K5-K7, falling back
    loudly to 'bcd_pallas' where its gate fails), 'bcd_pallas' (K1-K4,
    one point after another) or 'bcd' (the plain reference sweep).  With
    ``cfg.screen_every > 0`` the sequential paths screen at every check."""
    if method == "bcd_batch" and compact:
        raise ValueError(
            "method='bcd_batch' does not support compact=True (the batched "
            "grid shares one A stream; compaction is per-point).  Use "
            "compact=False, or method='bcd_ws' for support-compacted path "
            "points.")
    if compact:
        raise NotImplementedError(
            "compact=True is not ported yet (ROADMAP queue 1, item 8)")
    if mesh is not None:
        raise NotImplementedError(
            "sharded paths are not ported yet (ROADMAP queue 1, item 13)")
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"the {method!r} path is not ported yet "
            f"(ROADMAP {NOT_PORTED[method]})")
    if method not in ("fista", "ista", "bcd", "bcd_pallas", "bcd_batch"):
        raise ValueError(f"unknown method {method!r}")

    if lambdas is None:
        lmax = float(lambda_max_t(problem.A_t, problem.b, problem.penalty))
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                            problem.device)
    lambdas = torch.as_tensor(lambdas, dtype=problem.dtype,
                              device=problem.device)

    if method == "bcd_batch":
        from convex_optimization_tpu_torch.solvers.batched_path import (
            batched_lambda_path,
        )

        return batched_lambda_path(problem, cfg, lambdas=lambdas)
    if method in ("fista", "ista"):
        return _fista_path(problem, cfg, lambdas, method)
    return _sequential_path(problem, cfg, lambdas, method)


def _path_result(problem: Problem, cfg: SolverConfig, lambdas, xs, gaps,
                 iters, method: str) -> PathResult:
    dev = problem.device
    gaps_t = torch.tensor(gaps, dtype=problem.dtype, device=dev)
    return PathResult(
        lambdas=lambdas, xs=torch.stack(xs), gaps=gaps_t,
        iters=torch.tensor(iters, dtype=torch.int64, device=dev),
        method_used=method, converged=gaps_t <= cfg.tol,
        sweeps=sum(iters))


def _fista_path(problem: Problem, cfg: SolverConfig, lambdas: torch.Tensor,
                method: str) -> PathResult:
    """The JAX package's FISTA path (its ``lambda_path.py:303-317``): one
    L_total, each point warm-started at the previous point's last iterate
    with the residual from K2; returns the last iterates and their
    gaps."""
    L_total = float(spectral_norm_sq_t(problem.A_t)) + problem.lam2
    col_norms = fista_mod.screen_norms(problem, cfg, None)
    xs, gaps, iters = [], [], []
    x_warm = None
    for lam in lambdas.tolist():
        p = problem.with_lam1(lam)
        state = fista_mod.init_state(p, None)
        if x_warm is not None:
            r_w = ax_minus_b_t(p.A_t, x_warm, p.b)
            state = state._replace(x=x_warm, r=r_w, x_prev=x_warm,
                                   r_prev=r_w, x_best=x_warm)
        state = fista_mod.fista(p, L_total, state, cfg, col_norms)
        x_warm = state.x
        xs.append(state.x)
        gaps.append(state.rel_gap)
        iters.append(state.k)
    return _path_result(problem, cfg, lambdas, xs, gaps, iters, method)


def _sequential_path(problem: Problem, cfg: SolverConfig,
                     lambdas: torch.Tensor, method: str) -> PathResult:
    cfg = dataclasses.replace(cfg, use_pallas=(method == "bcd_pallas"))
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    bs = None
    if cfg.use_pallas:
        # pad-free block first, capped at 128 (wider blocks slow
        # Gauss-Seidel convergence), as the JAX package picks it
        picked = pick_block_size_t(problem.n, min(cfg.block_size, 128),
                                   multiple)
        if picked[1] == 0:
            bs = picked[0]
    if bs is None:
        bs = bcd_mod.pick_block_size(problem.n, cfg.block_size,
                                     multiple_of=multiple)
    problem = problem.with_block(bs)
    if cfg.use_pallas:
        bcd_mod.prepare_sweep(problem.A_t)
    block_L = (block_power_t(problem.A_t) if cfg.use_pallas
               else block_power_t_plain(problem.A_t))
    col_norms = bcd_mod.screen_norms(problem, cfg, None)

    xs, gaps, iters = [], [], []
    x_warm = None
    for lam in lambdas.tolist():
        p = problem.with_lam1(lam)
        state = bcd_mod.init_state(p, None)
        if x_warm is not None:
            r_w = (ax_minus_b_t(p.A_t, x_warm, p.b) if cfg.use_pallas
                   else p.residual(x_warm))
            state = state._replace(x=x_warm, r=r_w, x_best=x_warm)
        state = bcd_mod.bcd(p, block_L, state, cfg, col_norms)
        x_warm = state.x_best
        xs.append(state.x_best)
        gaps.append(state.best_rel_gap)
        iters.append(state.k)
    return _path_result(problem, cfg, lambdas, xs, gaps, iters, method)
