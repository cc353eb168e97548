"""Batched-lambda path: every path point iterates at once against one read
of A per sweep.

Counterpart of ``convex_optimization_tpu/solvers/batched_path.py``.  The
sequential path (``solvers/lambda_path.py``) reads A once per sweep per
point; this one runs cyclic Gauss-Seidel block prox on an (L, n) batch of
iterates, each row with its own threshold, so the whole grid costs
max_l sweeps(lam_l) reads of A instead of their sum.  Points start cold;
at every check each point adopts its larger-lambda neighbour's iterate
when that is primal-better at its own lambda (the cascade warm start).
Certification matches lambda_path: per-point f32 duality gaps with
best-iterate tracking and stall detection.

The JAX package runs the loop as one jitted while_loop; here it is a host
loop, as in ``solvers/bcd.py``: ``gap_every`` K5 sweeps, then the check on
device tensors (a K6 refresh, the row mask, a K7 witness, the gap over
(L,), best-iterate tracking and the cascade), then ONE host sync reading
(L,) best_rel and since_best for the exit test.  The stall, best-iterate,
cascade and chunking rules are unchanged.

Not ported: the sharded route (ROADMAP queue 1, item 13) and the TPU's
per-execution sweep budget (``EXEC_SWEEP_BUDGET``), which existed only
because long executions killed the TPU worker.  The JAX gate's HBM check
for a second copy of A does not carry over either: here A is a view of
A_t, so no second copy exists.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from convex_optimization_tpu_torch.core.objective import (
    gap_from_parts,
    lambda_max_t,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    block_steps,
    pick_block_size_t,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    MAX_BATCH,
    ax_minus_b_batch_t,
    batch_sweep_t,
    eligible_batch,
    neg_at_r_batch_t,
    rows_of,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.lambda_path import (
    PathResult,
    lambda_path,
    path_grid,
)


class _BatchState(NamedTuple):
    X: torch.Tensor            # (n_blocks, L, B) iterates
    R: torch.Tensor            # (L, m) residuals
    X_best: torch.Tensor       # (n_blocks, L, B) best-certified iterates
    R_best: torch.Tensor       # (L, m) exact residual at X_best (chunk
                               # warm starts reuse it)
    best_gap: torch.Tensor     # (L,)
    best_rel: torch.Tensor     # (L,)
    best_primal: torch.Tensor  # (L,)
    iters_done: torch.Tensor   # (L,) sweep count when each point was best
    since_best: torch.Tensor   # (L,) checks without a new best
    k: int                     # sweeps run


def _penalty_parts(kind: str, gsize: int, weights, X: torch.Tensor,
                   Z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lambda base penalty value and base dual norm (lam1 factored
    out): value_l = lam1_l * base_val_l, dual_norm_l = base_dual_l /
    lam1_l.  X, Z are (n_blocks, L, B); weights (n_blocks, 1, B/gsize)."""
    if kind == "l1":
        return X.abs().sum(dim=(0, 2)), Z.abs().amax(dim=(0, 2))
    if kind == "nonneg_l1":
        return (X.sum(dim=(0, 2)),                       # X >= 0 by prox
                torch.clamp(Z.amax(dim=(0, 2)), min=0.0))
    if kind == "group_l2":
        nb, L, B = X.shape
        gpb = B // gsize
        gn_x = torch.linalg.vector_norm(X.reshape(nb, L, gpb, gsize), dim=3)
        gn_z = torch.linalg.vector_norm(Z.reshape(nb, L, gpb, gsize), dim=3)
        return ((weights * gn_x).sum(dim=(0, 2)),
                (gn_z / weights).amax(dim=(0, 2)))
    raise ValueError(f"unknown penalty kind {kind!r}")


def _init_batch_state(nb: int, B: int, m: int, L: int, b: torch.Tensor,
                      x0: torch.Tensor | None, r0: torch.Tensor | None,
                      dtype: torch.dtype,
                      rm: torch.Tensor | None = None) -> _BatchState:
    """Cold (zeros / -b) or warm (x0 (nb, B) / r0 (m,) broadcast over L)
    start.  With a row mask the cold residual is the masked -b (residual
    rows stay rm * (A x - b) throughout); a warm r0 is already masked (it
    comes from a masked run's R_best)."""
    dev = b.device
    if x0 is None:
        X0 = torch.zeros((nb, L, B), dtype=dtype, device=dev)
        b_eff = b if rm is None else rm * b
        R0 = (-b_eff).to(dtype)[None, :].expand(L, m).contiguous()
    else:
        X0 = x0.to(dtype)[:, None, :].expand(nb, L, B).contiguous()
        R0 = r0.to(dtype)[None, :].expand(L, m).contiguous()
    inf = torch.full((L,), float("inf"), dtype=dtype, device=dev)
    zeros = torch.zeros((L,), dtype=torch.int32, device=dev)
    return _BatchState(X=X0, R=R0, X_best=X0, R_best=R0, best_gap=inf,
                       best_rel=inf, best_primal=inf, iters_done=zeros,
                       since_best=zeros, k=0)


def _run_batched_loop(state: _BatchState, lam1s: torch.Tensor,
                      cfg: SolverConfig, sweep_once: Callable,
                      gap_check: Callable) -> _BatchState:
    """gap_every sweeps -> certify -> best-iterate tracking -> cascade warm
    start, until every point is converged or stalled, or max_iters.
    sweep_once(X, R) -> (X, R); gap_check(X, R) -> (R_exact, GapInfo over
    (L,), rho_aug, base_val)."""
    L = lam1s.shape[0]
    not_first = torch.arange(L, device=lam1s.device) > 0
    while state.k < cfg.max_iters:
        X, R = state.X, state.R
        for _ in range(cfg.gap_every):
            X, R = sweep_once(X, R)
        R, info, rho_aug, base_val = gap_check(X, R)
        k = state.k + cfg.gap_every
        improved = info.rel_gap < state.best_rel
        X_best = torch.where(improved[None, :, None], X, state.X_best)
        R_best = torch.where(improved[:, None], R, state.R_best)
        best_rel = torch.where(improved, info.rel_gap, state.best_rel)
        best_gap = torch.where(improved, info.gap, state.best_gap)
        best_primal = torch.where(improved, info.primal, state.best_primal)
        iters_done = state.iters_done.masked_fill(improved, k)
        since_best = (state.since_best + 1).masked_fill(improved, 0)

        # cascade warm start: point l adopts point l-1's CURRENT iterate
        # when that iterate is primal-better at lam_l, evaluated from the
        # parts already reduced: P_l(x_{l-1}) = 0.5 rho_aug_{l-1}
        # + lam1_l base_val_{l-1}.  Lambdas descend, so the shift is
        # l-1 -> l; GS prox descent is monotone from any start.
        prev_aug = torch.cat([rho_aug[:1], rho_aug[:-1]])
        prev_val = torch.cat([base_val[:1], base_val[:-1]])
        primal_of_prev = 0.5 * prev_aug + lam1s * prev_val
        adopt = ((primal_of_prev < info.primal) & not_first
                 & (state.best_rel > cfg.tol))
        X = torch.where(adopt[None, :, None],
                        torch.cat([X[:, :1], X[:, :-1]], dim=1), X)
        R = torch.where(adopt[:, None], torch.cat([R[:1], R[:-1]]), R)
        state = _BatchState(X=X, R=R, X_best=X_best, R_best=R_best,
                            best_gap=best_gap, best_rel=best_rel,
                            best_primal=best_primal, iters_done=iters_done,
                            since_best=since_best, k=k)

        # the check's one host sync
        rel, since = torch.stack(
            [best_rel.double(), since_best.double()]).tolist()
        converged = [r <= cfg.tol for r in rel]
        stalled = [cfg.stall_checks > 0 and s >= cfg.stall_checks
                   for s in since]
        if all(c or s for c, s in zip(converged, stalled)):
            break
    return state


def _solve_batched(A_t: torch.Tensor, b: torch.Tensor, lam1s: torch.Tensor,
                   lam2: float, steps: torch.Tensor, penalty, weights,
                   state0: _BatchState, rm: torch.Tensor | None,
                   gsize: int, cfg: SolverConfig) -> _BatchState:
    """One chunk of the grid.  rm (m,) solves the row-masked problem
    (rm * A, rm * b) on the same A_t: the mask gates K5's residual updates
    and the refresh, so every gap quantity is the masked problem's."""
    kind = penalty.kind

    def sweep_once(X, R):
        return batch_sweep_t(A_t, X, R, steps, lam1s, lam2, penalty,
                             row_mask=rm)

    def gap_check(X, R):
        # the exact refresh pins the incremental residual's drift, then
        # one batched witness pass; gap_from_parts broadcasts over (L,)
        R = ax_minus_b_batch_t(A_t, X, b)
        if rm is not None:
            R = rm[None, :] * R
        Z = neg_at_r_batch_t(A_t, R, X, lam2)
        base_val, base_dual = _penalty_parts(kind, gsize, weights, X, Z)
        rho_aug = (R * R).sum(dim=1) + lam2 * (X * X).sum(dim=(0, 2))
        info = gap_from_parts(
            rho_dot_b=-torch.mv(R, b),
            rho_aug_sq=rho_aug,
            g_value=lam1s * base_val,
            dual_norm_value=base_dual / torch.clamp(lam1s, min=1e-30),
        )
        return R, info, rho_aug, base_val

    return _run_batched_loop(state0, lam1s, cfg, sweep_once, gap_check)


def _batch_gate_reason(problem: Problem, picked: tuple[int, int],
                       chunk: int) -> str | None:
    """None when the batched kernels can run; else a readable reason."""
    if picked[1] != 0:
        return (f"no pad-free block size for (m={problem.m}, "
                f"n={problem.n})")
    if not eligible_batch(problem.m, problem.n, picked[0], chunk,
                          dtype=problem.dtype, device=problem.device):
        return (f"eligible_batch failed for (m={problem.m}, "
                f"n={problem.n}, B={picked[0]}, L={chunk}, "
                f"dtype={problem.dtype})")
    return None


def chunk_size(L: int) -> int:
    """Points per batched run: grids past MAX_BATCH run in consecutive
    equal chunks, each warm-started from the previous chunk's deepest
    solution."""
    return -(-L // -(-L // MAX_BATCH))


class PreparedBatch(NamedTuple):
    """One-time batched-solver set-up (block choice, K4), reusable across
    grids and row masks: K-fold CV's folds and refit share one."""
    solve_chunk: Callable | None  # (lam_c, x_warm, r_warm, rm) -> state
    A_t: torch.Tensor | None      # the (n_blocks, B, m) view of A
    reason: str | None            # not None => gate failed


def prepare_batched_solver(problem: Problem, cfg: SolverConfig, *,
                           chunk: int = MAX_BATCH) -> PreparedBatch:
    """Gate and set-up for the batched path.  When the gate fails, returns
    the reason with solve_chunk None (callers fall back loudly)."""
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    picked = pick_block_size_t(problem.n, 128, multiple)
    reason = _batch_gate_reason(problem, picked, chunk)
    if reason is not None:
        return PreparedBatch(None, None, reason)

    B = picked[0]
    n_blocks = problem.n // B
    A_t = problem.with_block(B).A_t
    # full-data block Lipschitz: a row mask only removes rows, so it
    # bounds every masked block's too (sound steps, no per-fold K4)
    steps = block_steps(block_power_t(A_t), problem.lam2, cfg.step_scale)
    weights = None
    if problem.penalty.kind == "group_l2":
        weights = problem.penalty._gweights(
            problem.dtype, problem.device).reshape(n_blocks, 1, B // multiple)

    def solve_chunk(lam_c, x_warm, r_warm, rm=None):
        state = _init_batch_state(n_blocks, B, problem.m, lam_c.shape[0],
                                  problem.b, x_warm, r_warm, problem.dtype,
                                  rm)
        return _solve_batched(A_t, problem.b, lam_c.contiguous(),
                              problem.lam2, steps, problem.penalty, weights,
                              state, rm, multiple, cfg)

    return PreparedBatch(solve_chunk, A_t, None)


def batched_lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: torch.Tensor | None = None,
    row_mask: torch.Tensor | None = None,
    prepared: PreparedBatch | None = None,
) -> PathResult:
    """Solve the whole lambda grid at once; see the module docstring.

    Falls back to the sequential ``bcd_pallas`` path when the gate fails
    (not f32, no pad-free block size, or a K5 tile past shared memory),
    with a warning; ``PathResult.method_used`` records the solver that
    ran.  With ``row_mask`` ((m,), 0/1) the path solves the row-masked
    problem (rm * A, rm * b) against the same A_t.  Pass ``prepared``
    (from :func:`prepare_batched_solver`) to share one set-up across
    calls, e.g. across CV folds."""
    rm = None
    if row_mask is not None:
        rm = torch.as_tensor(row_mask, dtype=problem.dtype,
                             device=problem.device).reshape(problem.m)
    if lambdas is None:
        b_eff = problem.b if rm is None else problem.b * rm
        # (rm A)^T (rm b) = A^T (rm b) for a 0/1 mask: no masked copy
        lmax = float(lambda_max_t(problem.A_t, b_eff, problem.penalty))
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                            problem.device)
    lambdas = torch.as_tensor(lambdas, dtype=problem.dtype,
                              device=problem.device)
    L = lambdas.shape[0]
    chunk = chunk_size(L)

    prep = prepared
    if prep is None:
        prep = prepare_batched_solver(problem, cfg, chunk=min(L, chunk))
    if prep.reason is not None:
        warnings.warn(
            f"bcd_batch gate failed ({prep.reason}); falling back to the "
            f"sequential bcd_pallas path — PathResult.method_used records "
            f"the substitution", stacklevel=2)
        p_eff = problem
        if rm is not None:
            # only reached where the gate fails, so the copy is small
            p_eff = dataclasses.replace(problem, A_t=problem.A_t * rm,
                                        b=problem.b * rm)
        return lambda_path(p_eff, cfg, lambdas=lambdas, method="bcd_pallas")

    xs_parts, gaps_parts, iters_parts = [], [], []
    sweeps = 0
    x_warm = r_warm = None
    for c0 in range(0, L, chunk):
        lam_c = lambdas[c0:c0 + chunk]
        final = prep.solve_chunk(lam_c, x_warm, r_warm, rm)
        Lc = lam_c.shape[0]
        xs_parts.append(rows_of(final.X_best))
        gaps_parts.append(final.best_rel)
        iters_parts.append(final.iters_done)
        sweeps += final.k
        if c0 + chunk < L:
            # warm-start the next chunk at the deepest certified point;
            # R_best is its exact (and, with a mask, masked) residual
            x_warm = final.X_best[:, Lc - 1, :]
            r_warm = final.R_best[Lc - 1]

    gaps = torch.cat(gaps_parts)
    return PathResult(
        lambdas=lambdas, xs=torch.cat(xs_parts), gaps=gaps,
        iters=torch.cat(iters_parts), method_used="bcd_batch",
        converged=gaps <= cfg.tol, sweeps=sweeps)
