"""FISTA / ISTA proximal gradient, with the state and check helpers that
the BCD loop shares.

Counterpart of ``convex_optimization_tpu/solvers/fista.py``.  The JAX
package runs the whole solve as one jitted while_loop; here the loop runs
on the host, as ``bcd.py`` does: ``gap_every`` steps, then one check with
one host sync.  Per step one witness pass (K3, the gradient at the
momentum point, whose residual comes from linearity: r_y = r + beta (r -
r_prev)) and one refresh pass (K2, the exact residual at the new iterate).
The momentum scalar and the adaptive-restart test stay on the device
(``torch.where``), so a step issues no host sync.
"""

from __future__ import annotations

import math

import torch

from convex_optimization_tpu_torch.core.objective import (
    dual_witness,
    gap_from_parts,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.matvec import ax_minus_b_t, neg_at_r_t
from convex_optimization_tpu_torch.solvers.common import (
    History,
    SolverConfig,
    SolveState,
    count_nnz,
    record_check,
)


def _check_and_record(problem: Problem, state: SolveState,
                      z: torch.Tensor | None = None,
                      col_norms: torch.Tensor | None = None) -> SolveState:
    """Duality-gap check + history record, with ONE host sync: the gap's
    scalars and the support size come back in a single transfer.  Pass a
    precomputed ``z`` (= -A^T r - lam2 x, from K3) to skip the plain
    witness.  With ``col_norms`` (the augmented column norms; callers pass
    them when ``cfg.screen_every > 0``) the gap-safe screen at this check
    tightens the keep mask on the device, as the JAX package's check
    does."""
    x, r = state.x, state.r
    if z is None:
        z = dual_witness(problem, x, r)
    rr = torch.dot(r, r)
    info = gap_from_parts(
        rho_dot_b=-torch.dot(r, problem.b),
        rho_aug_sq=rr + problem.lam2 * torch.dot(x, x),
        g_value=problem.penalty.value(x),
        dual_norm_value=problem.penalty.dual_norm(z),
    )
    keep = state.keep_mask
    if col_norms is not None:
        keep = keep & problem.penalty.screen_keep(
            z, info.alpha, info.gap, col_norms, r_norm=torch.sqrt(rr),
            primal=info.primal)
    vals = torch.stack([info.gap, info.primal, info.dual, info.rel_gap,
                        count_nnz(x).to(info.gap.dtype)]).tolist()
    host = dict(zip(("gap", "primal", "dual", "rel_gap"), vals[:4]))
    return record_check(state, host, x, int(vals[4]), keep)


def init_state(problem: Problem, x0: torch.Tensor | None,
               keep_mask: torch.Tensor | None = None,
               r0: torch.Tensor | None = None) -> SolveState:
    """Start state at x0 (zeros when None; then r = -b exactly, no
    matvec).  ``r0``: the residual A x0 - b when the caller has it (the
    working-set solver threads K2's residual from its screen into every
    warm start); else it is computed here."""
    n, dtype, device = problem.n, problem.dtype, problem.device
    if x0 is None:
        x = torch.zeros((n,), dtype=dtype, device=device)
        r = -problem.b.to(dtype)
    else:
        x = x0.to(device=device, dtype=dtype).clone()
        r = problem.residual(x) if r0 is None else r0.to(dtype)
    if keep_mask is None:
        keep_mask = torch.ones((n,), dtype=torch.bool, device=device)
    return SolveState(
        x=x, r=r, k=0,
        rel_gap=math.inf, gap=math.inf, primal=math.inf,
        keep_mask=keep_mask, history=History(),
        best_rel_gap=math.inf, stall=0, x_best=x, best_gap=math.inf,
        best_primal=math.inf,
        x_prev=x, r_prev=r, t_mom=torch.ones((), dtype=dtype, device=device),
    )


def screen_norms(problem: Problem, cfg: SolverConfig,
                 col_norms: torch.Tensor | None) -> torch.Tensor | None:
    """The column norms the checks screen with: None when screening is
    off, else ``col_norms`` or, when not given, the problem's."""
    if cfg.screen_every <= 0:
        return None
    return problem.col_norms() if col_norms is None else col_norms


def momentum_point(state: SolveState, cfg: SolverConfig):
    """(t_next, y, r_y): the FISTA extrapolation and its residual by
    linearity; ISTA returns the iterate itself."""
    if not cfg.momentum:
        return state.t_mom, state.x, state.r
    t = state.t_mom
    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
    beta = (t - 1.0) / t_next
    y = state.x + beta * (state.x - state.x_prev)
    r_y = state.r + beta * (state.r - state.r_prev)
    return t_next, y, r_y


def finish_step(state: SolveState, cfg: SolverConfig, t_next, y, x_new,
                r_new, restart_dot: torch.Tensor | None) -> SolveState:
    """The new state after a step; with momentum and adaptive restart,
    ``restart_dot`` = <y - x_new, x_new - x> > 0 resets the momentum."""
    x, r = state.x, state.r
    if cfg.momentum and cfg.adaptive_restart:
        do_restart = restart_dot > 0.0
        t_next = torch.where(do_restart, torch.ones_like(t_next), t_next)
        x_prev = torch.where(do_restart, x_new, x)
        r_prev = torch.where(do_restart, r_new, r)
    else:
        x_prev, r_prev = x, r
    return state._replace(x=x_new, r=r_new, x_prev=x_prev, r_prev=r_prev,
                          t_mom=t_next, k=state.k + 1)


def fista_step(problem: Problem, L_total: float, state: SolveState,
               cfg: SolverConfig) -> SolveState:
    """One FISTA (ISTA when ``cfg.momentum`` is False) iteration; both
    matvecs go through K3 and K2 (plain versions for CPU tensors)."""
    t_next, y, r_y = momentum_point(state, cfg)
    g = -neg_at_r_t(problem.A_t, r_y, y, problem.lam2)   # A^T r_y + lam2 y
    step = 1.0 / L_total
    x_new = problem.penalty.prox(y - step * g, step)
    x_new = torch.where(state.keep_mask, x_new, torch.zeros_like(x_new))
    r_new = ax_minus_b_t(problem.A_t, x_new, problem.b)
    dot = (torch.dot(y - x_new, x_new - state.x)
           if cfg.momentum and cfg.adaptive_restart else None)
    return finish_step(state, cfg, t_next, y, x_new, r_new, dot)


def continue_loop(s: SolveState, cfg: SolverConfig) -> bool:
    go = s.k < cfg.max_iters and s.rel_gap > cfg.tol
    if cfg.stall_checks > 0:
        go = go and s.stall < cfg.stall_checks
    return go


def fista(problem: Problem, L_total: float, state: SolveState,
          cfg: SolverConfig,
          col_norms: torch.Tensor | None = None) -> SolveState:
    """Run FISTA until rel. duality gap <= cfg.tol, ``max_iters``
    iterations or ``stall_checks`` checks without a new best.  L_total
    must be >= ||A||_2^2 + lam2 (``ops.matvec.spectral_norm_sq_t``); the
    check's witness is K3's.  With ``cfg.screen_every > 0`` every check
    screens (``col_norms``: the problem's augmented column norms, computed
    here when not given)."""
    L_total = float(L_total)
    # lam1 as a Python float: read once here, not once per step
    problem = problem.with_lam1(float(problem.penalty.lam1))
    col_norms = screen_norms(problem, cfg, col_norms)

    def check(s: SolveState) -> SolveState:
        z = neg_at_r_t(problem.A_t, s.r, s.x, problem.lam2)
        return _check_and_record(problem, s, z=z, col_norms=col_norms)

    state = check(state)
    while continue_loop(state, cfg):
        for _ in range(cfg.gap_every):
            state = fista_step(problem, L_total, state, cfg)
        state = check(state)
    return state
