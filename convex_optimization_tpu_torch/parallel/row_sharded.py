"""Row-sharded FISTA and Gauss-Seidel BCD over ``torch.distributed``.

Counterpart of ``convex_optimization_tpu/parallel/row_sharded.py``.  The
rows of A (and b) are split over the ranks of a ``RowGroup``: each rank
owns a contiguous row slab, stored as its own (n/B, B, m/R) ``A_t``, and
the matching slice of the residual r = A x - b; x is replicated.  Per
FISTA step the only collective is one all-reduce of an n-vector (the
gradient consensus):

    FISTA step:  K3 on the slab (lam2 = 0), all-reduce of -A_loc^T r_loc
                 (n floats), grad = sum + lam2 y, the prox, the keep mask;
                 K2 on the slab: r_loc = A_loc x - b_loc (no collective);
                 the restart dot locally (x is replicated)
    BCD step:    cyclic Gauss-Seidel, as on one device: per block j, K3 on
                 the one-block view (lam2 = 0), an all-reduce of B floats,
                 + lam2 x_j, the block prox, the keep mask, and K2 on the
                 same view adds A_j dx to r_loc.  One collective a block:
                 latency-bound by design (the JAX docstring's "chatter");
                 the right layout when m >> n.  An exact refresh (K2 on
                 the slab) before every check pins the drift.
    check:       one all-reduce of [-A_loc^T r_loc, <r_loc, b_loc>,
                 ||r_loc||^2] (n + 2 floats), the gap from its parts, the
                 stop numbers from group rank 0 (as the column layout's
                 check); with screening, the global column norms.

K3 adds -lam2 x on every slab, so the slabs pass lam2 = 0 and lam2 enters
once, after the all-reduce.  The set-up (``prepare_rows``) builds the
slab, then L_total by the power iteration over the slabs (FISTA) or each
block's ||A_j||^2 from the Grams of the slabs summed over the ranks (K4's
two stages, BCD), and the global column norms when the checks screen.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from convex_optimization_tpu_torch.core.objective import (
    gap_from_parts,
    raw_dual_norm,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import block_steps
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_gram_t,
    block_power_gram_t,
    neg_at_r_t,
    power_iteration,
    sin_start,
)
from convex_optimization_tpu_torch.parallel._loop import (
    check_loop,
    finish_check,
)
from convex_optimization_tpu_torch.parallel.collectives import psum
from convex_optimization_tpu_torch.parallel.mesh import RowGroup
from convex_optimization_tpu_torch.solvers.bcd import pick_block_size
from convex_optimization_tpu_torch.solvers.common import (
    SolverConfig,
    SolveState,
    count_nnz,
)
from convex_optimization_tpu_torch.solvers.fista import (
    finish_step,
    init_state,
    momentum_point,
)
from convex_optimization_tpu_torch.utils.device import sync as _sync


def shard_rows(problem: Problem, g: RowGroup, block: int) -> Problem:
    """This rank's row slab of ``problem`` as a Problem of its own on
    ``g.device``: rows rank * m/R .. of every block of ``A_t`` at width
    ``block``, copied once into a contiguous (n/B, B, m/R) tensor (the
    strided view would be refused by the kernels), b's slice and the
    whole penalty (x is replicated)."""
    m, R = problem.m, g.size
    if m % R != 0:
        raise ValueError(f"m={m} must divide over {R} shards")
    m_loc = m // R
    r0 = g.rank * m_loc
    A_t = problem.A_t.view(problem.n // block, block, m)[..., r0:r0 + m_loc]
    A_t = A_t.to(g.device).contiguous()
    pen = problem.penalty.with_lam1(float(problem.penalty.lam1))
    if pen.weights is not None:
        pen = dataclasses.replace(pen, weights=pen.weights.to(g.device))
    return Problem(A_t=A_t, b=problem.b[r0:r0 + m_loc].to(g.device),
                   penalty=pen, lam2=problem.lam2)


def _gap_check_rows(loc: Problem, s: SolveState, g: RowGroup,
                    col_norms: torch.Tensor | None) -> SolveState:
    """The JAX package's ``_gap_check_rows``: one all-reduce of the slab's
    partials, the gap, rank 0's numbers, and with ``col_norms`` (global)
    the gap-safe screen."""
    x, r, pen, n = s.x, s.r, loc.penalty, loc.n
    part = torch.cat([neg_at_r_t(loc.A_t, r, torch.zeros_like(x), 0.0),
                      torch.stack([torch.dot(r, loc.b), torch.dot(r, r)])])
    tot = psum(part, g)
    z = tot[:n] - loc.lam2 * x
    r_sq = tot[n + 1]
    info = gap_from_parts(rho_dot_b=-tot[n],
                          rho_aug_sq=r_sq + loc.lam2 * torch.dot(x, x),
                          g_value=torch.as_tensor(pen.value(x),
                                                  dtype=x.dtype,
                                                  device=x.device),
                          dual_norm_value=pen.dual_norm(z))
    return finish_check(s, info, count_nnz(x).to(x.dtype), r_sq, z, pen, g,
                        col_norms)


def sharded_fista_rows(loc: Problem, L_total: float, state: SolveState,
                       cfg: SolverConfig, g: RowGroup,
                       col_norms: torch.Tensor | None = None) -> SolveState:
    """FISTA (ISTA without momentum) on this rank's row slab ``loc``
    (``shard_rows``) with the global step 1 / L_total; ``state`` holds the
    replicated x and the slab's r.  ``col_norms``: the global augmented
    column norms, to screen at every check (None: no screening)."""
    step_size = 1.0 / float(L_total)
    restart = cfg.momentum and cfg.adaptive_restart
    zeros_n = torch.zeros((loc.n,), dtype=loc.dtype, device=loc.device)

    def step(s: SolveState) -> SolveState:
        t_next, y, r_y = momentum_point(s, cfg)
        grad = -psum(neg_at_r_t(loc.A_t, r_y, zeros_n, 0.0), g) \
            + loc.lam2 * y
        x_new = loc.penalty.prox(y - step_size * grad, step_size)
        x_new = torch.where(s.keep_mask, x_new, torch.zeros_like(x_new))
        r_new = ax_minus_b_t(loc.A_t, x_new, loc.b)
        dot = torch.dot(y - x_new, x_new - s.x) if restart else None
        return finish_step(s, cfg, t_next, y, x_new, r_new, dot)

    return check_loop(state, cfg, step,
                      lambda s: _gap_check_rows(loc, s, g, col_norms))


def gs_block_steps(block_L: torch.Tensor, lam2: float,
                   cfg: SolverConfig) -> list:
    """t_j = step_scale / (L_j + lam2) as host floats (f32 values, so a
    step multiplies as the kernels' f32 step does; no sync per block)."""
    return block_steps(block_L, lam2, cfg.step_scale).tolist()


def sharded_bcd_rows(loc: Problem, block_L: torch.Tensor, state: SolveState,
                     cfg: SolverConfig, g: RowGroup,
                     col_norms: torch.Tensor | None = None) -> SolveState:
    """Cyclic Gauss-Seidel block-CD on this rank's row slab ``loc``, x
    replicated (the JAX package's ``sharded_bcd_rows``): each block's
    gradient is all-reduced over the ranks (B floats) before its prox, so
    the sweep is the one-device sweep's arithmetic.  ``block_L`` holds
    every block's ||A_j||^2 over all rows (no lam2); B = n / len(block_L).
    ``col_norms`` as in ``sharded_fista_rows``; the sweep freezes the
    screened coordinates through the keep mask."""
    nb = block_L.shape[0]
    B = loc.n // nb
    loc = loc.with_block(B)
    pen, lam2 = loc.penalty, loc.lam2
    if pen.kind == "group_l2" and B % (loc.n // pen.ngroups) != 0:
        raise ValueError("block size must contain whole groups")
    steps = gs_block_steps(block_L, lam2, cfg)
    views = [loc.A_t[j:j + 1] for j in range(nb)]
    zeros_B = torch.zeros((B,), dtype=loc.dtype, device=loc.device)

    def step(s: SolveState) -> SolveState:
        x, r = s.x.clone(), s.r
        for j, (A_j, t) in enumerate(zip(views, steps)):
            cols = slice(j * B, (j + 1) * B)
            xj = x[cols]
            grad = -psum(neg_at_r_t(A_j, r, zeros_B, 0.0), g) + lam2 * xj
            xn = pen.prox_block(xj - t * grad, t, j, loc.n)
            xn = torch.where(s.keep_mask[cols], xn, torch.zeros_like(xn))
            r = ax_minus_b_t(A_j, xn - xj, -r)        # r + A_j (xn - xj)
            x[cols] = xn
        return s._replace(x=x, r=r, k=s.k + 1)

    return check_loop(state, cfg, step,
                      lambda s: _gap_check_rows(loc, s, g, col_norms),
                      refresh=lambda x: ax_minus_b_t(loc.A_t, x, loc.b))


# ------------------------------------------------------------ set-up ----

def rows_spectral_norm_sq(loc: Problem, g: RowGroup) -> torch.Tensor:
    """||A||_2^2 of the whole A from the row slabs: K2 on the slab gives
    this rank's rows of A v, K3 on the slab and an all-reduce A^T u; x-side
    dots are local (replicated), r-side dots all-reduced."""
    zeros_m = torch.zeros_like(loc.b)
    zeros_n = torch.zeros((loc.n,), dtype=loc.dtype, device=loc.device)
    return power_iteration(
        lambda v: ax_minus_b_t(loc.A_t, v, zeros_m),
        lambda u: -psum(neg_at_r_t(loc.A_t, u, zeros_n, 0.0), g),
        sin_start(loc.n, loc.dtype, loc.device),
        udot=lambda a, b: psum(torch.dot(a, b).reshape(1), g)[0])


def summed_block_L(loc: Problem, g) -> torch.Tensor:
    """Each block's ||A_j||^2 over all rows: K4's Gram stage on this
    rank's row slab, the Grams all-reduced over ``g`` (the row ranks),
    then K4's iteration stage on the sum."""
    G = block_gram_t(loc.A_t)
    return block_power_gram_t(psum(G, g))


def global_col_norms(loc: Problem, g) -> torch.Tensor:
    """The augmented column norms sqrt(||A_j||^2 + lam2) over all rows: the
    slab's squared norms all-reduced over ``g`` first (a slab's own norms
    would make the screen unsafe)."""
    sq = psum(torch.linalg.vector_norm(loc.A_rows, dim=1) ** 2, g)
    return torch.sqrt(sq + loc.lam2)


def rows_lambda_max(loc: Problem, g: RowGroup,
                    b: torch.Tensor | None = None) -> float:
    """lambda_max of the whole problem: K3 on the slab against b_loc
    (lam2 = 0), all-reduced, then the raw dual norm of A^T b."""
    zeros_n = torch.zeros((loc.n,), dtype=loc.dtype, device=loc.device)
    z = psum(neg_at_r_t(loc.A_t, -(loc.b if b is None else b), zeros_n,
                        0.0), g)
    return float(raw_dual_norm(z, loc.penalty))


def prepare_rows(problem: Problem, method: str, cfg: SolverConfig,
                 g: RowGroup):
    """The row layout's set-up of ``method`` ("fista", "ista" or "bcd"):
    the block width (``pick_block_size`` on the full n, as the JAX
    package), the slab, the kernel build, then, timed, L_total (FISTA) or
    the summed-Gram block_L (BCD), and the global column norms when the
    checks screen.  Returns a ``parallel.sharded.ShardedSetup``."""
    from convex_optimization_tpu_torch.parallel.sharded import ShardedSetup

    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    bs = pick_block_size(problem.n, cfg.block_size, multiple_of=multiple)
    loc = shard_rows(problem, g, bs)
    dev = g.device
    if dev.type == "cuda":
        _build.load()
    _sync(dev)
    t0 = time.perf_counter()
    if method == "bcd":
        lip = summed_block_L(loc, g)
    else:
        lip = float(rows_spectral_norm_sq(loc, g)) + loc.lam2
    col_norms = global_col_norms(loc, g) if cfg.screen_every > 0 else None
    _sync(dev)
    return ShardedSetup(loc=loc, method=method, cfg=cfg, lipschitz=lip,
                        col_norms=col_norms,
                        setup_s=time.perf_counter() - t0)


def rows_state(loc: Problem, x: torch.Tensor | None) -> SolveState:
    """A fresh state at the replicated x (zeros when None), the slab's
    residual by K2 on the slab."""
    state = init_state(loc, None)
    if x is None:
        return state
    x = x.to(device=loc.device, dtype=loc.dtype).clone()
    r = ax_minus_b_t(loc.A_t, x, loc.b)
    return state._replace(x=x, r=r, x_best=x, x_prev=x, r_prev=r)
