"""Grid-sharded FISTA and BCD: A tiled over R x C ranks (``GridGroup``).

Counterpart of ``convex_optimization_tpu/parallel/grid_sharded.py``, the
composition of the row and column layouts for an A too large for one
card in both dimensions.  Rank (r, c) owns the (m/R) x (n/C) tile of A,
stored as its own (n/C/B, B, m/R) ``A_t``, b's row slice r, and x's
column slice c; r is replicated over the C ranks of a row shard.  Every
collective runs over one axis of the grid and is of local size:

    FISTA step:  K3 on the tile (lam2 = 0), all-reduced over the rows
                 (n/C floats), + lam2 y; the prox; K2 on the tile,
                 all-reduced over the blocks with the restart dot (m/R + 1
                 floats), - b_loc
    BCD step:    within the tile's column slab, Gauss-Seidel with each
                 block's gradient all-reduced over the rows (B floats, as
                 the row layout); across the column shards, Jacobi: the
                 shards' [dr, <x,dx>, <dx,dx>, dG] summed over the blocks
                 (m/R + 3 floats), [<r,dr>, <dr,dr>] over the rows, and the
                 line search of the column layout, floored at 1/C; an exact
                 refresh (K2, an all-reduce over the blocks) before each
                 check
    check:       one all-reduce over the rows of [-A_loc^T r_loc,
                 <r_loc, b_loc>, ||r_loc||^2], pmax over the blocks of the
                 dual norm, psum over the blocks of ||x||^2, g(x) and nnz,
                 the stop numbers from world rank 0

The tiles pass lam2 = 0 to K3 and lam2 enters after the all-reduce.  The
BCD set-up sums the tile blocks' Grams over the rows (K4's two stages).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from convex_optimization_tpu_torch.core.objective import gap_from_parts
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    neg_at_r_t,
    power_iteration,
    sin_start,
)
from convex_optimization_tpu_torch.parallel._loop import (
    check_loop,
    finish_check,
)
from convex_optimization_tpu_torch.parallel.collectives import pmax, psum
from convex_optimization_tpu_torch.parallel.mesh import GridGroup
from convex_optimization_tpu_torch.parallel.row_sharded import (
    global_col_norms,
    gs_block_steps,
    summed_block_L,
)
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


def _check_grid(problem: Problem, g: GridGroup) -> None:
    """The JAX package's refusals of a problem the grid cannot tile."""
    m, n, R, C = problem.m, problem.n, g.rows.size, g.blocks.size
    if m % R != 0 or n % C != 0:
        raise ValueError(f"(m={m}, n={n}) must divide over ({R}, {C})")
    pen = problem.penalty
    if pen.kind == "group_l2" and pen.ngroups % C != 0:
        raise ValueError("ngroups must divide over block shards")


def shard_grid(problem: Problem, g: GridGroup, block: int) -> Problem:
    """This rank's tile of ``problem`` as a Problem of its own on
    ``g.device``: columns c * n/C .. and rows r * m/R .. of A, copied once
    into a contiguous (n/C/B, B, m/R) ``A_t`` at width ``block``, b's row
    slice and the column shard's penalty."""
    from convex_optimization_tpu_torch.parallel.sharded import _local_penalty

    _check_grid(problem, g)
    pen = problem.penalty
    C = g.blocks.size
    m_loc, n_loc = problem.m // g.rows.size, problem.n // C
    if n_loc % block != 0:
        raise ValueError(f"block {block} does not divide n/C={n_loc}")
    r0, c0 = g.rows.rank * m_loc, g.blocks.rank * n_loc
    tile = problem.A_rows[c0:c0 + n_loc, r0:r0 + m_loc]
    A_t = tile.to(g.device).contiguous().view(n_loc // block, block, m_loc)
    pen = _local_penalty(pen.with_lam1(float(pen.lam1)), C, g.blocks.rank)
    if pen.weights is not None:
        pen = dataclasses.replace(pen, weights=pen.weights.to(g.device))
    return Problem(A_t=A_t, b=problem.b[r0:r0 + m_loc].to(g.device),
                   penalty=pen, lam2=problem.lam2)


def _gap_check_grid(loc: Problem, s: SolveState, g: GridGroup,
                    col_norms: torch.Tensor | None) -> SolveState:
    """The JAX package's ``_gap_check_grid``: each partial reduced over
    its own axis of the grid, then world rank 0's numbers, and with
    ``col_norms`` (the column shard's, over all rows) the screen."""
    x, r, pen, n = s.x, s.r, loc.penalty, loc.n
    part = torch.cat([neg_at_r_t(loc.A_t, r, torch.zeros_like(x), 0.0),
                      torch.stack([torch.dot(r, loc.b), torch.dot(r, r)])])
    tot = psum(part, g.rows)
    z = tot[:n] - loc.lam2 * x
    dn = pmax(pen.dual_norm(z).reshape(1), g.blocks)[0]
    x_sq, g_val, nnz = psum(torch.stack([
        torch.dot(x, x), torch.as_tensor(pen.value(x), dtype=x.dtype,
                                         device=x.device),
        count_nnz(x).to(x.dtype)]), g.blocks)
    r_sq = tot[n + 1]
    info = gap_from_parts(rho_dot_b=-tot[n],
                          rho_aug_sq=r_sq + loc.lam2 * x_sq,
                          g_value=g_val, dual_norm_value=dn)
    return finish_check(s, info, nnz, r_sq, z, pen, g.world, col_norms)


def _residual(loc: Problem, g: GridGroup, x: torch.Tensor) -> torch.Tensor:
    """The row shard's r = A x - b: K2 on the tile, all-reduced over the
    blocks, - b_loc."""
    return psum(ax_minus_b_t(loc.A_t, x, torch.zeros_like(loc.b)),
                g.blocks) - loc.b


def grid_sharded_fista(loc: Problem, L_total: float, state: SolveState,
                       cfg: SolverConfig, g: GridGroup,
                       col_norms: torch.Tensor | None = None) -> SolveState:
    """FISTA (ISTA without momentum) on this rank's tile ``loc``
    (``shard_grid``) with the global step 1 / L_total; ``state`` holds
    the column slice of x and the row slice of r.  ``col_norms``: the
    column shard's augmented norms over all rows (None: no screening)."""
    step_size = 1.0 / float(L_total)
    restart = cfg.momentum and cfg.adaptive_restart
    zeros_n = torch.zeros((loc.n,), dtype=loc.dtype, device=loc.device)
    zeros_m = torch.zeros_like(loc.b)
    m = loc.m

    def step(s: SolveState) -> SolveState:
        t_next, y, r_y = momentum_point(s, cfg)
        grad = -psum(neg_at_r_t(loc.A_t, r_y, zeros_n, 0.0), g.rows) \
            + loc.lam2 * y
        x_new = loc.penalty.prox(y - step_size * grad, step_size)
        x_new = torch.where(s.keep_mask, x_new, torch.zeros_like(x_new))
        part = ax_minus_b_t(loc.A_t, x_new, zeros_m)          # A_loc x_new
        if restart:
            part = torch.cat([part, torch.dot(y - x_new, x_new - s.x)[None]])
        tot = psum(part, g.blocks)
        return finish_step(s, cfg, t_next, y, x_new, tot[:m] - loc.b,
                           tot[m] if restart else None)

    return check_loop(state, cfg, step,
                      lambda s: _gap_check_grid(loc, s, g, col_norms))


def grid_sharded_bcd(loc: Problem, block_L: torch.Tensor, state: SolveState,
                     cfg: SolverConfig, g: GridGroup,
                     col_norms: torch.Tensor | None = None) -> SolveState:
    """Block-CD on this rank's tile ``loc``: Gauss-Seidel over the column
    shard's blocks (each block's gradient all-reduced over the rows),
    Jacobi across the column shards with the line-searched merge, floored
    at 1/C.  ``block_L`` holds the column shard's per-block ||A_j||^2 over
    all rows (no lam2).  ``col_norms`` as in ``grid_sharded_fista``."""
    nb = block_L.shape[0]
    B = loc.n // nb
    loc = loc.with_block(B)
    pen, lam2, m, C = loc.penalty, loc.lam2, loc.m, g.blocks.size
    if pen.kind == "group_l2" and B % (loc.n // pen.ngroups) != 0:
        raise ValueError("block size must contain whole groups")
    steps = gs_block_steps(block_L, lam2, cfg)
    views = [loc.A_t[j:j + 1] for j in range(nb)]
    zeros_B = torch.zeros((B,), dtype=loc.dtype, device=loc.device)
    zeros_m = torch.zeros_like(loc.b)

    def step(s: SolveState) -> SolveState:
        x_loc, r_rep = s.x, s.r
        x, dr, r_cur = x_loc.clone(), zeros_m, r_rep
        for j, (A_j, t) in enumerate(zip(views, steps)):
            cols = slice(j * B, (j + 1) * B)
            xj = x[cols]
            grad = -psum(neg_at_r_t(A_j, r_cur, zeros_B, 0.0), g.rows) \
                + lam2 * xj
            xn = pen.prox_block(xj - t * grad, t, j, loc.n)
            xn = torch.where(s.keep_mask[cols], xn, torch.zeros_like(xn))
            d = ax_minus_b_t(A_j, xn - xj, zeros_m)   # the slice's A_j dx
            x[cols] = xn
            dr, r_cur = dr + d, r_cur + d
        dx = x - x_loc
        pay = psum(torch.cat([dr, torch.stack([
            torch.dot(x_loc, dx), torch.dot(dx, dx),
            torch.as_tensor(pen.value_diff(x_loc, dx), dtype=dx.dtype,
                            device=dx.device)])]), g.blocks)
        dr = pay[:m]
        lin, den = psum(torch.stack([torch.dot(r_rep, dr),
                                     torch.dot(dr, dr)]), g.rows)
        lin = lin + lam2 * pay[m]
        den = den + lam2 * pay[m + 1]
        gamma = torch.clamp(-(lin + pay[m + 2]) / torch.clamp(den, min=1e-30),
                            0.0, 1.0)
        gamma = torch.clamp(gamma, min=1.0 / C)
        return s._replace(x=x_loc + gamma * dx, r=r_rep + gamma * dr,
                          k=s.k + 1)

    return check_loop(state, cfg, step,
                      lambda s: _gap_check_grid(loc, s, g, col_norms),
                      refresh=lambda x: _residual(loc, g, x))


# ------------------------------------------------------------ set-up ----

def grid_spectral_norm_sq(loc: Problem, g: GridGroup) -> torch.Tensor:
    """||A||_2^2 of the whole A from the tiles: A v by K2 on the tile and
    an all-reduce over the blocks, A^T u by K3 on the tile and an
    all-reduce over the rows; n-side dots over the blocks, m-side dots
    over the rows; the start is this column shard's slice of sin(1..n)."""
    zeros_m = torch.zeros_like(loc.b)
    zeros_n = torch.zeros((loc.n,), dtype=loc.dtype, device=loc.device)
    return power_iteration(
        lambda v: psum(ax_minus_b_t(loc.A_t, v, zeros_m), g.blocks),
        lambda u: -psum(neg_at_r_t(loc.A_t, u, zeros_n, 0.0), g.rows),
        sin_start(loc.n, loc.dtype, loc.device, lo=g.blocks.rank * loc.n),
        vdot=lambda a, b: psum(torch.dot(a, b).reshape(1), g.blocks)[0],
        udot=lambda a, b: psum(torch.dot(a, b).reshape(1), g.rows)[0])


def prepare_grid(problem: Problem, method: str, cfg: SolverConfig,
                 g: GridGroup):
    """The grid layout's set-up of ``method`` ("fista", "ista" or
    "bcd"): the block width (``pick_block_size`` on n/C, as the JAX
    package), the tile, the kernel build, then, timed, L_total (FISTA) or
    the column shard's block_L from the tile Grams summed over the rows
    (BCD), and the column shard's norms over all rows when the checks
    screen.  Returns a ``parallel.sharded.ShardedSetup``."""
    from convex_optimization_tpu_torch.parallel.sharded import ShardedSetup

    _check_grid(problem, g)
    C = g.blocks.size
    gsz = 1
    if problem.penalty.kind == "group_l2":
        gsz = problem.n // problem.penalty.ngroups
    bs = pick_block_size(problem.n // C, cfg.block_size, multiple_of=gsz)
    loc = shard_grid(problem, g, bs)
    dev = g.device
    if dev.type == "cuda":
        _build.load()
    _sync(dev)
    t0 = time.perf_counter()
    if method == "bcd":
        lip = summed_block_L(loc, g.rows)
    else:
        lip = float(grid_spectral_norm_sq(loc, g)) + loc.lam2
    col_norms = (global_col_norms(loc, g.rows) if cfg.screen_every > 0
                 else None)
    _sync(dev)
    return ShardedSetup(loc=loc, method=method, cfg=cfg, lipschitz=lip,
                        col_norms=col_norms,
                        setup_s=time.perf_counter() - t0)


def grid_state(loc: Problem, g: GridGroup,
               x_loc: torch.Tensor | None) -> SolveState:
    """A fresh state at the column slice ``x_loc`` (zeros when None), the
    row shard's residual by K2 on the tile and an all-reduce over the
    blocks."""
    state = init_state(loc, None)
    if x_loc is None:
        return state
    x = x_loc.to(device=loc.device, dtype=loc.dtype).clone()
    r = _residual(loc, g, x)
    return state._replace(x=x, r=r, x_best=x, x_prev=x, r_prev=r)
