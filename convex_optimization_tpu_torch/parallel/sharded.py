"""Column-sharded FISTA and BCD over ``torch.distributed``, and the
routing of every sharded layout.

Counterpart of ``convex_optimization_tpu/parallel/sharded.py``.
``solve_sharded`` (behind ``api.solve(mesh=g)``) routes by ``g.axis`` as
the JAX package routes by the mesh's axes: a ``GridGroup`` to
``grid_sharded.py``, a ``RowGroup`` to ``row_sharded.py``, a
``ColumnGroup`` to the column layout here.  A's columns are split over
the ranks of a ``ColumnGroup``: each rank owns a contiguous slab of
``A_t`` blocks and the matching slice of x; the residual r = A x - b is
replicated and kept in consensus by one all-reduce of an m-vector per
iteration.

Every rank runs the same host loop (one sync per check); where the JAX
package runs one shard_map'd program, the ranks here meet only at the
collectives.  The check's numbers come from group rank 0 to every rank,
so that the ranks make the same stop decision (and, with
``screen_every > 0``, screen against the same gap-safe sphere) even
where the ring consensus leaves their residuals a rounding apart.

The set-up (block width, the slab, K4 or L_total, the slab's column
norms) is built once by ``prepare_sharded`` and reused by every point of
a sharded lambda path (``solvers/lambda_path.py``); ``prepare_sharded``,
``sharded_state``, ``run_sharded``, ``gather_x`` and
``sharded_lambda_max`` take any of the three groups.

    FISTA step:  K3 on the slab, prox, K2 on the slab; one all-reduce of
                 [A_loc x_new, <y - x_new, x_new - x>] (m + 1 floats)
    BCD step:    K8 on the slab (K9 where its tile does not fit), one
                 all-reduce of K8's payload [dr, <x,dx>, <dx,dx>, dG]
                 (m + 3 floats), then the line search on the summed
                 direction with its 1/P floor
    check:       K3 on the slab, pmax of the dual norm, psum of ||x||^2,
                 g(x) and nnz; with screening, the slab's columns tested
                 against rank 0's gap, alpha, primal and ||r||
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from convex_optimization_tpu_torch.core.objective import (
    gap_from_parts,
    lambda_max_t,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    H100_SMS,
    block_steps,
    pick_block_size_t,
    sweep_route,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_slab import (
    merge_payload,
    sweep_slab_t,
    sweep_slab_t_plain,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_tiled import sweep_tiled_t
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    block_power_t_plain,
    neg_at_r_t,
    power_iteration,
    sin_start,
)
from convex_optimization_tpu_torch.parallel import grid_sharded as gs
from convex_optimization_tpu_torch.parallel import row_sharded as rs
from convex_optimization_tpu_torch.parallel._loop import (
    check_loop,
    finish_check,
)
from convex_optimization_tpu_torch.parallel.collectives import (
    all_gather,
    pmax,
    psum,
    reduce_scatter_gather,
    ring_psum,
    ring_psum_chunked,
)
from convex_optimization_tpu_torch.parallel.mesh import (
    GRID,
    ROWS,
    ColumnGroup,
    check_group,
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


def _consensus_fn(cfg: SolverConfig, g: ColumnGroup):
    """The residual-consensus all-reduce of ``cfg.consensus``, returning a
    new tensor: flat psum, the neighbour ring, or reduce-scatter +
    all-gather (its payload padded with zeros to a multiple of P, so the
    scatter runs whatever m is)."""
    if cfg.consensus == "ring":
        return lambda v: ring_psum(v, g)
    if cfg.consensus == "reduce_scatter":
        def rs(v):
            pad = -v.shape[0] % g.size
            return reduce_scatter_gather(F.pad(v, (0, pad)), g)[:v.shape[0]]
        return rs
    if cfg.consensus != "psum":
        raise ValueError(f"unknown consensus {cfg.consensus!r}")
    return lambda v: psum(v.clone(), g)


def _local_penalty(penalty: Penalty, n_shards: int, rank: int) -> Penalty:
    """The slab's view of the penalty (group counts and weights divide
    over the ranks)."""
    if penalty.kind != "group_l2":
        return penalty
    ng = penalty.ngroups // n_shards
    w = penalty.weights
    return dataclasses.replace(
        penalty, ngroups=ng,
        weights=None if w is None else w[rank * ng:(rank + 1) * ng])


def shard_columns(problem: Problem, g: ColumnGroup, block: int) -> Problem:
    """This rank's column slab of ``problem`` as a Problem of its own on
    ``g.device``: blocks rank * nb_loc .. of ``A_t`` at width ``block``
    (a view on the same device; from a CPU problem, e.g. one made by
    ``problem_from_numpy(..., device="cpu")`` on the JAX package's arrays,
    one upload of the slab alone), b replicated, the slab's penalty."""
    n, P = problem.n, g.size
    if n % P != 0:
        raise ValueError(f"n={n} must divide over {P} shards")
    pen = problem.penalty
    if pen.kind == "group_l2" and pen.ngroups % P != 0:
        raise ValueError("ngroups must divide over shards")
    if n % block != 0 or (n // block) % P != 0:
        raise ValueError("n_blocks must divide evenly over mesh devices")
    n_loc = n // P
    rows = problem.A_rows[g.rank * n_loc:(g.rank + 1) * n_loc]
    A_t = rows.view(n_loc // block, block, problem.m).to(g.device)
    pen = _local_penalty(pen.with_lam1(float(pen.lam1)), P, g.rank)
    if pen.weights is not None:
        pen = dataclasses.replace(pen, weights=pen.weights.to(g.device))
    return Problem(A_t=A_t, b=problem.b.to(g.device), penalty=pen,
                   lam2=problem.lam2)


def _gap_check_local(loc: Problem, s: SolveState, g: ColumnGroup,
                     col_norms: torch.Tensor | None = None) -> SolveState:
    """Duality gap from the ranks' combined partials (pmax of the dual
    norm; psum of ||x||^2, g(x) and nnz), then record_check with rank 0's
    numbers: one host sync.  With ``col_norms`` (the slab's augmented
    column norms) the gap-safe screen tightens the slab's keep mask, as
    the JAX package's check does (its ``parallel/sharded.py:99-103``),
    with rank 0's gap, alpha, primal and ||r||: every rank tests its
    columns against the same sphere."""
    x, r, pen = s.x, s.r, loc.penalty
    z = neg_at_r_t(loc.A_t, r, x, loc.lam2)
    dn = pmax(pen.dual_norm(z).reshape(1), g)[0]
    x_sq, g_val, nnz = psum(torch.stack([
        torch.dot(x, x), torch.as_tensor(pen.value(x), dtype=x.dtype,
                                         device=x.device),
        count_nnz(x).to(x.dtype)]), g)
    rr = torch.dot(r, r)
    info = gap_from_parts(rho_dot_b=-torch.dot(r, loc.b),
                          rho_aug_sq=rr + loc.lam2 * x_sq,
                          g_value=g_val, dual_norm_value=dn)
    return finish_check(s, info, nnz, rr, z, pen, g, col_norms)


def sharded_fista(loc: Problem, L_total: float, state: SolveState,
                  cfg: SolverConfig, g: ColumnGroup,
                  col_norms: torch.Tensor | None = None) -> SolveState:
    """FISTA (ISTA without momentum) on this rank's slab ``loc``
    (``shard_columns``) with the global step 1 / L_total; ``state`` holds
    the slab's x and the replicated r.  ``col_norms``: the slab's
    augmented column norms, to screen at every check (None: no
    screening)."""
    L_total = float(L_total)
    allreduce = _consensus_fn(cfg, g)
    restart = cfg.momentum and cfg.adaptive_restart
    zeros_m = torch.zeros_like(loc.b)
    step_size = 1.0 / L_total
    m = loc.m

    def step(s: SolveState) -> SolveState:
        t_next, y, r_y = momentum_point(s, cfg)
        grad = -neg_at_r_t(loc.A_t, r_y, y, loc.lam2)
        x_new = loc.penalty.prox(y - step_size * grad, step_size)
        x_new = torch.where(s.keep_mask, x_new, torch.zeros_like(x_new))
        part = ax_minus_b_t(loc.A_t, x_new, zeros_m)          # A_loc x_new
        if restart:
            part = torch.cat([part, torch.dot(y - x_new, x_new - s.x)[None]])
        tot = allreduce(part)
        return finish_step(s, cfg, t_next, y, x_new, tot[:m] - loc.b,
                           tot[m] if restart else None)

    return check_loop(state, cfg, step, lambda st: _gap_check_local(
        loc, st, g, col_norms))


def _slab_sweep(loc: Problem, B: int, cfg: SolverConfig):
    """The sweep of a slab at block width B: K8 (K1's kernel with the
    payload, on K1's plan) where K1's tile fits, K9 with the payload as
    tensor ops otherwise; the plain version without ``use_pallas`` (as the
    JAX package's oracle route)."""
    if not cfg.use_pallas:
        return sweep_slab_t_plain
    dev = loc.device
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    if sweep_route(B, loc.m, sms) == "k1":
        return sweep_slab_t

    def k9(A_t, x, r, steps, keep, pen, lam2):
        x_out, r_out = sweep_tiled_t(A_t, x, r, steps, keep, pen, lam2)
        return x_out, r_out, merge_payload(x, x_out, r, r_out, pen)
    return k9


def sharded_bcd(loc: Problem, block_L: torch.Tensor, state: SolveState,
                cfg: SolverConfig, g: ColumnGroup,
                col_norms: torch.Tensor | None = None) -> SolveState:
    """Block-CD: Gauss-Seidel within this rank's slab ``loc``, Jacobi
    across ranks.  ``block_L`` holds the slab's per-block ||A_j||^2 (no
    lam2).  Each step sweeps the slab against the consensus residual, sums
    the ranks' payloads, and moves x and r by gamma along the summed
    direction: the exact line search of the convex bound, floored at 1/P
    (Jacobi averaging, always a descent).  With ``consensus="ring"`` the
    slab sweeps in two halves and the first half's ring is in flight while
    the second half sweeps.  ``col_norms`` as in ``sharded_fista``: the
    sweeps freeze the screened coordinates through their keep mask."""
    nb_loc = block_L.shape[0]
    B = loc.n // nb_loc
    loc = loc.with_block(B)
    m, lam2, P = loc.m, loc.lam2, g.size
    steps = block_steps(block_L, lam2, cfg.step_scale)
    sweep = _slab_sweep(loc, B, cfg)
    allreduce = _consensus_fn(cfg, g)
    split = cfg.consensus == "ring" and nb_loc >= 2
    bounds = ([(0, nb_loc // 2), (nb_loc // 2, nb_loc)] if split
              else [(0, nb_loc)])
    pen = loc.penalty
    slabs = []
    for lo, hi in bounds:
        pen_h = pen
        if pen.kind == "group_l2":
            gpb = pen.ngroups // nb_loc
            pen_h = dataclasses.replace(
                pen, ngroups=gpb * (hi - lo),
                weights=(None if pen.weights is None
                         else pen.weights[lo * gpb:hi * gpb]))
        slabs.append((slice(lo * B, hi * B), loc.A_t[lo:hi], steps[lo:hi],
                      pen_h))

    def step(s: SolveState) -> SolveState:
        x, r = s.x, s.r
        if not split:
            x_new, _, pay = sweep(loc.A_t, x, r, steps, s.keep_mask, pen,
                                  lam2)
            tot = allreduce(pay)
        else:
            xs, pending, r_cur = [], [], r
            for cols, A_h, steps_h, pen_h in slabs:
                x_h, r_cur, pay = sweep(A_h, x[cols], r_cur, steps_h,
                                        s.keep_mask[cols], pen_h, lam2)
                # in flight while the next half sweeps
                pending.append(ring_psum_chunked(pay, g, 2, async_op=True))
                xs.append(x_h)
            x_new = torch.cat(xs)
            tot = pending[0].wait()
            for p in pending[1:]:
                tot = tot + p.wait()
        dr = tot[:m]
        lin = torch.dot(r, dr) + lam2 * tot[m]
        den = torch.dot(dr, dr) + lam2 * tot[m + 1]
        gamma = torch.clamp(-(lin + tot[m + 2]) / torch.clamp(den, min=1e-30),
                            0.0, 1.0)
        gamma = torch.clamp(gamma, min=1.0 / P)
        return s._replace(x=x + gamma * (x_new - x), r=r + gamma * dr,
                          k=s.k + 1)

    return check_loop(state, cfg, step, lambda st: _gap_check_local(
        loc, st, g, col_norms))


def _sharded_spectral_norm_sq(loc: Problem, g: ColumnGroup) -> torch.Tensor:
    """||A||_2^2 of the whole A from the slabs: K2 on the slab and a psum
    give A v, K3 on the slab gives the slab's rows of A^T u; the start is
    this rank's slice of sin(1..n) (``ops.matvec.spectral_norm_sq_t``)."""
    n_loc, dev, dt = loc.n, loc.device, loc.dtype
    zeros_m = torch.zeros_like(loc.b)
    zeros_n = torch.zeros((n_loc,), dtype=dt, device=dev)
    return power_iteration(
        lambda v: psum(ax_minus_b_t(loc.A_t, v, zeros_m), g),
        lambda u: -neg_at_r_t(loc.A_t, u, zeros_n, 0.0),
        sin_start(n_loc, dt, dev, lo=g.rank * n_loc),
        lambda a, b: psum(torch.dot(a, b).reshape(1), g)[0])


def sharded_lambda_max(loc: Problem, g: ColumnGroup,
                       b: torch.Tensor | None = None) -> float:
    """lambda_max of the whole problem from the slabs: the raw dual norm
    of the slab's A^T b (K3 on the slab, ``lambda_max_t``), then pmax.
    ``b`` replaces the problem's (a row-masked b).  With a RowGroup, A^T
    b is all-reduced over the row slabs first."""
    if g.axis == ROWS:
        return rs.rows_lambda_max(loc, g, b)
    lm = lambda_max_t(loc.A_t, loc.b if b is None else b, loc.penalty)
    return float(pmax(lm.reshape(1), g)[0])


class ShardedSetup(NamedTuple):
    """What a sharded solve builds once; a sharded lambda path reuses it
    at every point."""

    loc: Problem                    # this rank's slab (column, row) or
                                    # tile (grid) at the sweep's width
    method: str                     # "fista", "ista" or "bcd"
    cfg: SolverConfig
    lipschitz: object               # BCD: the shard's block_L (K4); FISTA:
                                    # L_total (float)
    col_norms: torch.Tensor | None  # the shard's augmented column norms
                                    # over all rows (screen_every > 0),
                                    # else None
    setup_s: float                  # seconds of K4 or L_total and the norms


def prepare_sharded(problem: Problem, method: str, cfg: SolverConfig,
                    g) -> ShardedSetup:
    """The set-up of ``method`` ("fista", "ista" or "bcd") on this rank.
    The row and grid layouts: ``row_sharded.prepare_rows``,
    ``grid_sharded.prepare_grid``.  The column layout: the block width
    (K1's pad-free width for ``bcd`` with ``use_pallas``, as ``solve``
    picks it on one device), the slab (``shard_columns``), the kernel
    build, then, timed, K4 on the slab (BCD) or L_total by the power
    iteration over the slabs (FISTA), and the slab's column norms when the
    checks screen."""
    if g.axis == GRID:
        return gs.prepare_grid(problem, method, cfg, g)
    if g.axis == ROWS:
        return rs.prepare_rows(problem, method, cfg, g)
    check_group(g)
    P = g.size
    if problem.n % P != 0:
        raise ValueError(f"n={problem.n} must divide over {P} shards")
    n_loc = problem.n // P
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    bs = None
    if method == "bcd" and cfg.use_pallas:
        bs, pad = pick_block_size_t(n_loc, cfg.block_size, multiple)
        bs = None if pad else bs
    if bs is None:
        bs = pick_block_size(n_loc, cfg.block_size, multiple_of=multiple)
    loc = shard_columns(problem, g, bs)
    dev = g.device
    if dev.type == "cuda":
        _build.load()
    _sync(dev)
    t0 = time.perf_counter()
    if method == "bcd":
        lip = (block_power_t(loc.A_t) if cfg.use_pallas
               else block_power_t_plain(loc.A_t))
    else:
        lip = float(_sharded_spectral_norm_sq(loc, g)) + loc.lam2
    col_norms = loc.col_norms() if cfg.screen_every > 0 else None
    _sync(dev)
    return ShardedSetup(loc=loc, method=method, cfg=cfg, lipschitz=lip,
                        col_norms=col_norms,
                        setup_s=time.perf_counter() - t0)


def column_shards(g) -> ColumnGroup | None:
    """The ranks over which x is split: a ColumnGroup itself, a
    GridGroup's blocks; None for a RowGroup (x replicated)."""
    return None if g.axis == ROWS else g.blocks if g.axis == GRID else g


def x_slice(setup: ShardedSetup, g, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a full-length x."""
    cg = column_shards(g)
    if cg is None:
        return x
    n_loc = setup.loc.n
    return x[cg.rank * n_loc:(cg.rank + 1) * n_loc]


def gather_x(x_loc: torch.Tensor, g) -> torch.Tensor:
    """The full x from this rank's part, on every rank."""
    cg = column_shards(g)
    return x_loc if cg is None else all_gather(x_loc, cg)


def sharded_state(setup: ShardedSetup, g,
                  x_loc: torch.Tensor | None = None) -> SolveState:
    """A fresh state (counters, history and keep mask reset) at this
    rank's part of x ``x_loc`` (``x_slice``; zeros when None), its
    residual by K2 on the shard and, but for the row layout, a psum."""
    loc = setup.loc
    if g.axis == ROWS:
        return rs.rows_state(loc, x_loc)
    if g.axis == GRID:
        return gs.grid_state(loc, g, x_loc)
    state = init_state(loc, None)
    if x_loc is None:
        return state
    x = x_loc.to(device=loc.device, dtype=loc.dtype).clone()
    r = psum(ax_minus_b_t(loc.A_t, x, torch.zeros_like(loc.b)), g) - loc.b
    return state._replace(x=x, r=r, x_best=x, x_prev=x, r_prev=r)


def run_sharded(setup: ShardedSetup, state: SolveState, g,
                lam1: float | None = None) -> SolveState:
    """The sharded solver of ``setup`` on ``g``'s layout from ``state``,
    at ``lam1`` when given (a path point), else at the problem's."""
    loc = setup.loc if lam1 is None else setup.loc.with_lam1(lam1)
    bcd = setup.method == "bcd"
    if g.axis == ROWS:
        solver = rs.sharded_bcd_rows if bcd else rs.sharded_fista_rows
    elif g.axis == GRID:
        solver = gs.grid_sharded_bcd if bcd else gs.grid_sharded_fista
    else:
        solver = sharded_bcd if bcd else sharded_fista
    return solver(loc, setup.lipschitz, state, setup.cfg, g,
                  setup.col_norms)


def screened_count(state: SolveState, g) -> int:
    """Columns of the whole problem that the last check froze."""
    keep = state.keep_mask
    frozen = (keep.numel() - keep.sum()).to(torch.float64).reshape(1)
    cg = column_shards(g)
    return int((frozen if cg is None else psum(frozen, cg))[0])


def solve_sharded(problem: Problem, method: str, g, x0=None,
                  cfg: Optional[SolverConfig] = None, **cfg_overrides):
    """The sharded solve behind ``api.solve(mesh=g)``: every rank of ``g``
    (a ColumnGroup, RowGroup or GridGroup) calls it with the same
    ``problem`` (on the CPU or on ``g.device``) and gets the same Result,
    whose x is gathered to the full n; ``x0`` is the full start.  The
    column layout: BCD's block_L is K4 on each slab, FISTA's L_total the
    power iteration over the slabs.  The row and grid layouts take
    fista, ista, bcd and bcd_pallas (one program for the last two, as in
    the JAX package); their ``Result.method`` reads "row_sharded_<m>" or
    "grid_sharded_<m>".  With ``screen_every > 0`` every check screens
    (``Result.screened``: the columns of the whole problem the last check
    froze)."""
    from convex_optimization_tpu_torch.api import Result

    cfg = SolverConfig() if cfg is None else cfg
    if method == "ista":
        cfg_overrides.setdefault("momentum", False)
    if method == "bcd_pallas":
        method = "bcd"
        cfg_overrides.setdefault("use_pallas", True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    check_group(g)
    layout = {GRID: "grid", ROWS: "row"}.get(g.axis)
    if layout is not None:
        if method not in ("fista", "ista", "bcd"):
            raise ValueError(f"{layout} sharding supports fista/ista/bcd, "
                             f"got {method!r}")
        prefix = f"{layout}_sharded"
    else:
        if method not in ("fista", "ista", "bcd"):
            raise ValueError(f"unknown sharded method {method!r}")
        prefix = "sharded"
    setup = prepare_sharded(problem, method, cfg, g)
    state = sharded_state(setup, g,
                          None if x0 is None else x_slice(setup, g, x0))
    dev = g.device
    _sync(dev)
    t1 = time.perf_counter()
    final = run_sharded(setup, state, g)
    _sync(dev)
    wall = time.perf_counter() - t1
    return Result(
        x=gather_x(final.x_best, g), gap=final.best_gap,
        rel_gap=final.best_rel_gap, primal=final.best_primal,
        iterations=final.k, converged=final.best_rel_gap <= cfg.tol,
        wall_time_s=wall, history=final.history.trimmed(),
        method=f"{prefix}_{method}", config=cfg, setup_time_s=setup.setup_s,
        screened=screened_count(final, g) if cfg.screen_every > 0 else 0)
