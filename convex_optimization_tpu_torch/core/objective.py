"""Objective, Fenchel dual, and the certified duality-gap monitor.

Counterpart of ``convex_optimization_tpu/core/objective.py``, which derives
the conventions (r = A x - b, rho = -r):

    z      = A^T rho - lam2 x
    P(x)   = 0.5*(||r||^2 + lam2*||x||^2) + g(x)
    alpha  = <rho,b>/||rho~||^2 clipped to [0, 1/dual_norm(z)]
    D      = alpha * <rho, b> - 0.5 * alpha^2 * (||r||^2 + lam2*||x||^2)
    gap    = P(x) - D  >=  P(x) - P(x*)  >= 0
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops.matvec import neg_at_r_t


class GapInfo(NamedTuple):
    gap: torch.Tensor      # duality gap (absolute)
    primal: torch.Tensor   # P(x)
    dual: torch.Tensor     # D(theta)
    alpha: torch.Tensor    # residual scaling that made theta feasible
    rel_gap: torch.Tensor  # gap / max(|P|, tiny) — the 1e-6-grade criterion


def gap_from_parts(rho_dot_b: torch.Tensor, rho_aug_sq: torch.Tensor,
                   g_value: torch.Tensor,
                   dual_norm_value: torch.Tensor) -> GapInfo:
    """Duality gap from pre-reduced 0-d tensors:

    rho_dot_b:       <rho, b> = <b - Ax, b>
    rho_aug_sq:      ||r||^2 + lam2*||x||^2
    g_value:         g(x)
    dual_norm_value: penalty.dual_norm(z)
    """
    tiny = torch.finfo(rho_aug_sq.dtype).tiny
    feas = 1.0 / torch.clamp(dual_norm_value, min=1e-30)
    opt = rho_dot_b / torch.clamp(rho_aug_sq, min=tiny)
    alpha = torch.minimum(torch.clamp(opt, min=0.0), feas)
    primal = 0.5 * rho_aug_sq + g_value
    dual = alpha * rho_dot_b - 0.5 * alpha * alpha * rho_aug_sq
    gap = primal - dual
    rel = gap / torch.clamp(torch.abs(primal),
                            min=torch.finfo(primal.dtype).tiny)
    return GapInfo(gap=gap, primal=primal, dual=dual, alpha=alpha,
                   rel_gap=rel)


def dual_witness(problem: Problem, x: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """z = -A^T r - lam2 x, the unscaled dual certificate (plain matvec;
    solvers pass the K3 kernel's z instead)."""
    return -torch.mv(problem.A_rows, r) - problem.lam2 * x


def duality_gap(problem: Problem, x: torch.Tensor,
                r: torch.Tensor | None = None,
                z: torch.Tensor | None = None, *,
                precise: bool = False) -> GapInfo:
    """Certified duality gap at x.  precise=True recomputes everything in
    float64 (a full float64 copy of A: a verification path for small and
    mid-size problems)."""
    if precise:
        pen = problem.penalty
        if pen.weights is not None:
            pen = dataclasses.replace(pen,
                                      weights=pen.weights.to(torch.float64))
        problem = dataclasses.replace(
            problem, A_t=problem.A_t.to(torch.float64),
            b=problem.b.to(torch.float64), penalty=pen)
        x = x.to(device=problem.device, dtype=torch.float64)
        r = z = None
    if r is None:
        r = problem.residual(x)
    if z is None:
        z = dual_witness(problem, x, r)
    rho_aug_sq = torch.dot(r, r) + problem.lam2 * torch.dot(x, x)
    return gap_from_parts(
        rho_dot_b=-torch.dot(r, problem.b),
        rho_aug_sq=rho_aug_sq,
        g_value=problem.penalty.value(x),
        dual_norm_value=problem.penalty.dual_norm(z),
    )


def primal_value(problem: Problem, x: torch.Tensor,
                 r: torch.Tensor | None = None) -> torch.Tensor:
    """P(x) = 0.5 (||r||^2 + lam2 ||x||^2) + g(x), r = A x - b."""
    if r is None:
        r = problem.residual(x)
    return (0.5 * (torch.dot(r, r) + problem.lam2 * torch.dot(x, x))
            + problem.penalty.value(x))


def dual_value(problem: Problem, x: torch.Tensor,
               r: torch.Tensor | None = None) -> torch.Tensor:
    """D(theta) at the scaled residual of x (``duality_gap``'s dual)."""
    return duality_gap(problem, x, r).dual


def raw_dual_norm(z: torch.Tensor, penalty: Penalty) -> torch.Tensor:
    """The penalty's raw dual norm of a witness z (the lam1 at which x = 0
    satisfies the optimality condition against this witness)."""
    if penalty.kind == "l1":
        return torch.max(torch.abs(z))
    if penalty.kind == "nonneg_l1":
        return torch.clamp(torch.max(z), min=0.0)
    if penalty.kind == "group_l2":
        gn = torch.linalg.vector_norm(z.reshape(penalty.ngroups, -1), dim=1)
        return torch.max(gn / penalty._gweights(z.dtype, z.device))
    raise ValueError(f"unknown penalty kind {penalty.kind!r}")


def lambda_max(A: torch.Tensor, b: torch.Tensor,
               penalty: Penalty) -> torch.Tensor:
    """Smallest lam1 at which x* = 0 is optimal: raw dual norm of A^T b."""
    return raw_dual_norm(A.T @ b, penalty)


def lambda_max_t(A_t: torch.Tensor, b: torch.Tensor,
                 penalty: Penalty) -> torch.Tensor:
    """``lambda_max`` through the witness kernel K3: z = A^T b in one pass
    over A_t (n_blocks, B, m) (``convex_optimization_tpu/core/
    objective.py:155``)."""
    n_blocks, B, _ = A_t.shape
    z = neg_at_r_t(A_t, -b, torch.zeros((n_blocks * B,), dtype=A_t.dtype,
                                        device=A_t.device), 0.0)
    return raw_dual_norm(z, penalty)
