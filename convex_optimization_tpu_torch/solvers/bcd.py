"""Block-coordinate descent: Gauss-Seidel sweeps with a certified
duality-gap check every ``gap_every`` sweeps.

Counterpart of ``convex_optimization_tpu/solvers/bcd.py`` (its ``A_t``
branch).  The JAX package runs the whole solve as one jitted while_loop;
here the loop is Python on the host and the device work is one K1 launch
per sweep plus, per check, a K2 residual refresh and a K3 witness.  The
host syncs once per check, to read the gap that decides whether to go on.
"""

from __future__ import annotations

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import block_steps, sweep_t
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu_torch.ops.matvec import ax_minus_b_t, neg_at_r_t
from convex_optimization_tpu_torch.solvers.common import (
    SolverConfig,
    SolveState,
)
from convex_optimization_tpu_torch.solvers.fista import (  # noqa: F401
    _check_and_record,
    init_state,
)


def pick_block_size(n: int, target: int = 256, *,
                    multiple_of: int = 1) -> int:
    """Largest divisor of n that is <= target and a multiple of
    ``multiple_of``; falls back to the smallest valid divisor."""
    best = None
    d = multiple_of
    while d <= n:
        if n % d == 0:
            if d <= target:
                best = d
            elif best is None:
                best = d
                break
            else:
                break
        d += multiple_of
    if best is None:
        raise ValueError(f"no block size for n={n}, multiple_of={multiple_of}")
    return best


def _continue(s: SolveState, cfg: SolverConfig) -> bool:
    go = s.k < cfg.max_iters and s.rel_gap > cfg.tol
    if cfg.stall_checks > 0:
        go = go and s.stall < cfg.stall_checks
    return go


def bcd(problem: Problem, block_L: torch.Tensor, state: SolveState,
        cfg: SolverConfig) -> SolveState:
    """Sweep until rel. duality gap <= cfg.tol, max_iters sweeps, or
    ``stall_checks`` checks without a new best.  block_L holds per-block
    ||A_j||_2^2 (no lam2); B = n / len(block_L).

    cfg.use_pallas: sweeps, refresh and witness go through K1, K2, K3
    (kernels for CUDA tensors, their plain versions for CPU tensors);
    otherwise the plain reference sweep and matvecs."""
    n_blocks = block_L.shape[0]
    B = problem.n // n_blocks
    # lam1 as a Python float: read once here, not once per launch
    problem = problem.with_lam1(float(problem.penalty.lam1)).with_block(B)
    A_t, lam2 = problem.A_t, problem.lam2

    if cfg.use_pallas:
        steps = block_steps(block_L, lam2, cfg.step_scale)

        def sweep(st: SolveState):
            return sweep_t(A_t, st.x, st.r, steps, st.keep_mask,
                           problem.penalty, lam2)

        def refresh_and_check(s: SolveState) -> SolveState:
            # exact residual refresh once per check pins the drift of the
            # incrementally maintained r; K3 reuses the fresh r
            r = ax_minus_b_t(A_t, s.x, problem.b)
            z = neg_at_r_t(A_t, r, s.x, lam2)
            return _check_and_record(problem, s._replace(r=r), z=z)
    else:
        order = range(n_blocks)

        def sweep(st: SolveState):
            return bcd_sweep_ref(problem, st.x, st.r, block_L, order,
                                 step_scale=cfg.step_scale,
                                 keep_mask=st.keep_mask)

        def refresh_and_check(s: SolveState) -> SolveState:
            s = s._replace(r=problem.residual(s.x))
            return _check_and_record(problem, s)

    state = refresh_and_check(state)
    while _continue(state, cfg):
        for _ in range(cfg.gap_every):
            x, r = sweep(state)
            state = state._replace(x=x, r=r, k=state.k + 1)
        state = refresh_and_check(state)
    return state


__all__ = ["bcd", "pick_block_size", "init_state"]
