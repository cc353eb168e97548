"""Gap-safe screening: keep masks that the solvers consume, and host-side
compaction.

Counterpart of ``convex_optimization_tpu/solvers/screening.py``.  A
screened coordinate is provably zero at the current lam1; the solvers
freeze it through their keep mask (FISTA's prox, K1/K9's mask), which the
check tightens when ``SolverConfig.screen_every > 0``
(``solvers/fista._check_and_record``).  ``compact_problem`` drops the
screened columns for a smaller solve.

Safety property (tested): a gap-safe mask never discards a coordinate of
the support of the exact solution at the same lam1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import (
    dual_witness,
    duality_gap,
)
from convex_optimization_tpu_torch.core.problem import Problem, default_block


def gap_safe_keep_mask(problem: Problem, x: torch.Tensor,
                       r: torch.Tensor | None = None,
                       col_norms: torch.Tensor | None = None) -> torch.Tensor:
    """One-shot gap-safe screen at the point x: the (n,) bool keep mask."""
    if r is None:
        r = problem.residual(x)
    if col_norms is None:
        col_norms = problem.col_norms()
    z = dual_witness(problem, x, r)
    info = duality_gap(problem, x, r, z=z)
    return problem.penalty.screen_keep(
        z, info.alpha, info.gap, col_norms,
        r_norm=torch.linalg.vector_norm(r), primal=info.primal)


def compact_problem(problem: Problem, keep_mask, block: int = 0
                    ) -> tuple[Problem, torch.Tensor]:
    """Drop the screened columns: (smaller problem, int64 index tensor
    mapping its columns to the original's).  A group_l2 problem keeps
    whole groups (any kept member keeps its group) and their weights.  One
    gathering copy of the kept columns (an ``index_select`` of
    ``A_rows``), viewed with block width ``block``, or ``default_block``
    when 0."""
    keep = np.asarray(torch.as_tensor(keep_mask).cpu(), dtype=bool)
    pen = problem.penalty
    if pen.kind == "group_l2":
        gsize = problem.n // pen.ngroups
        gkeep = keep.reshape(-1, gsize).any(axis=1)
        keep = np.repeat(gkeep, gsize)
        gidx = torch.as_tensor(np.nonzero(gkeep)[0])
        pen = dataclasses.replace(
            pen, ngroups=int(gkeep.sum()),
            weights=(None if pen.weights is None
                     else pen.weights[gidx.to(pen.weights.device)]))
    idx = torch.as_tensor(np.nonzero(keep)[0], device=problem.device)
    k = int(idx.shape[0])
    A_rows = problem.A_rows.index_select(0, idx)
    blk = block or (default_block(k) if k else 1)
    small = dataclasses.replace(
        problem, A_t=A_rows.view(k // blk, blk, problem.m), penalty=pen)
    return small, idx
