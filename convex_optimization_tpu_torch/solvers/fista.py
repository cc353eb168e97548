"""FISTA support pieces used by the BCD loop.

Counterpart of ``convex_optimization_tpu/solvers/fista.py``; this slice
ports only ``init_state`` and ``_check_and_record``, which ``bcd.py``
imports.  The FISTA loop itself comes later (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import math

import torch

from convex_optimization_tpu_torch.core.objective import (
    dual_witness,
    gap_from_parts,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.solvers.common import (
    History,
    SolveState,
    count_nnz,
    record_check,
)


def _check_and_record(problem: Problem, state: SolveState,
                      z: torch.Tensor | None = None) -> SolveState:
    """Duality-gap check + history record, with ONE host sync: the gap's
    scalars and the support size come back in a single transfer.  Pass a
    precomputed ``z`` (= -A^T r - lam2 x, from K3) to skip the plain
    witness."""
    x, r = state.x, state.r
    if z is None:
        z = dual_witness(problem, x, r)
    info = gap_from_parts(
        rho_dot_b=-torch.dot(r, problem.b),
        rho_aug_sq=torch.dot(r, r) + problem.lam2 * torch.dot(x, x),
        g_value=problem.penalty.value(x),
        dual_norm_value=problem.penalty.dual_norm(z),
    )
    vals = torch.stack([info.gap, info.primal, info.dual, info.rel_gap,
                        count_nnz(x).to(info.gap.dtype)]).tolist()
    host = dict(zip(("gap", "primal", "dual", "rel_gap"), vals[:4]))
    return record_check(state, host, x, int(vals[4]), state.keep_mask)


def init_state(problem: Problem, x0: torch.Tensor | None,
               keep_mask: torch.Tensor | None = None) -> SolveState:
    """Start state at x0 (zeros when None; then r = -b exactly, no
    matvec)."""
    n, dtype, device = problem.n, problem.dtype, problem.device
    if x0 is None:
        x = torch.zeros((n,), dtype=dtype, device=device)
        r = -problem.b.to(dtype)
    else:
        x = x0.to(device=device, dtype=dtype).clone()
        r = problem.residual(x)
    if keep_mask is None:
        keep_mask = torch.ones((n,), dtype=torch.bool, device=device)
    return SolveState(
        x=x, r=r, k=0,
        rel_gap=math.inf, gap=math.inf, primal=math.inf,
        keep_mask=keep_mask, history=History(),
        best_rel_gap=math.inf, stall=0, x_best=x, best_gap=math.inf,
        best_primal=math.inf,
    )
