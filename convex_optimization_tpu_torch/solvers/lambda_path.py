"""Warm-started lambda path.

Counterpart of ``convex_optimization_tpu/solvers/lambda_path.py`` for
every single-device method: ``fista`` (the default), ``ista``, ``bcd``,
``bcd_pallas``, ``bcd_batch``, the working-set ``fista_ws`` / ``bcd_ws``,
``admm``, and the compacting path (``compact=True``).  A geometric grid
lam_max -> lam_min_frac * lam_max is solved point by point, each solve
warm-started at the previous point's solution, or, with
``method='bcd_batch'``, all at once (``solvers/batched_path.py``).

The FISTA path computes L_total = ||A||^2 + lam2 once (the K2/K3 power
iteration) and warm-starts each point at the previous point's LAST
iterate, returning the last iterates and their gaps, as the JAX package
does; 'ista' is the same path (the JAX package's sets no momentum=False,
so ``cfg.momentum`` decides).  The BCD paths hoist the per-block
Lipschitz constants (K4) once and warm-start at the previous point's best
iterate.  The working-set path builds one route for the whole path
(``working_set.make_ws_route``), the ADMM path one factorisation (and
warm-starts rho too), and the compacting path screens each point at its
warm start (K2/K3 on the full ``A_t``) and runs FISTA on the kept
columns.  Every warm start's residual comes from K2, and the grid's
lam_max from the witness kernel K3 (``lambda_max_t``).

With ``mesh`` (a ``parallel.mesh.ColumnGroup`` or ``RowGroup``) the path
runs sharded, as the JAX package's ``_lambda_path_sharded`` (its
``lambda_path.py:416-525``): 'fista' / 'ista' / 'bcd' / 'bcd_pallas'
solve the points one after another on the slabs (``parallel/sharded.py``
and ``row_sharded.py``: one set-up for the whole path; each point starts
at the previous point's best iterate with its counters and keep mask
reset) and return every point's gathered best iterate; 'bcd_batch' runs
the grid at once on column slabs (``solvers/batched_path.py``) and
refuses a RowGroup.  A ``GridGroup`` runs what the JAX package runs on a
grid mesh: the column path over its blocks sub-group, the same on every
row of ranks.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import (
    duality_gap,
    lambda_max_t,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
from convex_optimization_tpu_torch.parallel.mesh import (
    GRID,
    ROWS,
    check_group,
)
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    block_power_t_plain,
    neg_at_r_t,
    spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers import working_set as ws
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.screening import compact_problem
from convex_optimization_tpu_torch.utils.trace import span


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
    kept: torch.Tensor | None = None    # (path_len,) columns solved per
                                        # point (compact and working-set
                                        # paths; else None)
    histories: list | None = None   # per point, its checks' ``primal``
                                    # and ``rel_gap`` (numpy arrays; the
                                    # sharded and batched paths, for
                                    # chip_smoke.path_check; not in the
                                    # JAX package)


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
    admm_setup: str = "device",
) -> PathResult:
    """Warm-started path on the device of ``problem.A_t``.

    method: 'fista' (the default, as in the JAX package: K2/K3 steps) or
    'ista', 'bcd_batch' (every point at once through K5-K7, falling back
    loudly to 'bcd_pallas' where its gate fails), 'bcd_pallas' (K1-K4,
    one point after another), 'bcd' (the plain reference sweep),
    'fista_ws' / 'bcd_ws' (the working-set solver at every point, with
    ``kept`` its last working set), or 'admm' (one factorisation for the
    path; above ``api.ADMM_FENCE_DIM`` it needs ``admm_setup='host'``,
    else it warns and runs the FISTA path).  ``compact=True`` runs the
    compacting FISTA path whatever the method (but 'bcd_batch', which
    raises): ``kept`` holds the columns each point solved on.  With
    ``cfg.screen_every > 0`` the sequential paths screen at every check.
    The call is the span ``cot.lambda_path`` (``utils/trace``)."""
    points = path_len if lambdas is None else len(lambdas)
    with span("cot.lambda_path", method=method, points=points):
        return _lambda_path(problem, cfg, path_len, lam_min_frac, lambdas,
                            compact, mesh, method, admm_setup)


def _lambda_path(problem: Problem, cfg: SolverConfig, path_len: int,
                 lam_min_frac: float, lambdas, compact: bool, mesh,
                 method: str, admm_setup: str) -> PathResult:
    if method == "bcd_batch" and compact:
        raise ValueError(
            "method='bcd_batch' does not support compact=True (the batched "
            "grid shares one A stream; compaction is per-point).  Use "
            "compact=False, or method='bcd_ws' for support-compacted path "
            "points.")
    if mesh is not None:
        if compact:
            raise NotImplementedError("compact paths are single-device")
        check_group(mesh)
        if mesh.axis == GRID:
            mesh = mesh.blocks
        if method == "bcd_batch":
            if mesh.axis == ROWS:
                raise ValueError(
                    "method='bcd_batch' runs on column slabs only: pass a "
                    "ColumnGroup, or a RowGroup with method='fista', "
                    "'ista', 'bcd' or 'bcd_pallas'")
            from convex_optimization_tpu_torch.solvers.batched_path import (
                batched_lambda_path,
            )

            return batched_lambda_path(problem, cfg, path_len=path_len,
                                       lam_min_frac=lam_min_frac,
                                       lambdas=lambdas, mesh=mesh)
        return _sharded_path(problem, cfg, mesh, path_len, lam_min_frac,
                             lambdas, method)
    if method not in ("fista", "ista", "bcd", "bcd_pallas", "bcd_batch",
                      "fista_ws", "bcd_ws", "admm"):
        raise ValueError(f"unknown method {method!r}")

    if lambdas is None:
        with span("cot.setup"):
            lmax = float(lambda_max_t(problem.A_t, problem.b,
                                      problem.penalty))
            lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                                problem.device)
    lambdas = torch.as_tensor(lambdas, dtype=problem.dtype,
                              device=problem.device)

    if compact:
        return _compact_path(problem, cfg, lambdas)
    if method == "bcd_batch":
        from convex_optimization_tpu_torch.solvers.batched_path import (
            batched_lambda_path,
        )

        return batched_lambda_path(problem, cfg, lambdas=lambdas)
    if method in ("fista", "ista"):
        return _fista_path(problem, cfg, lambdas, method)
    if method in ("fista_ws", "bcd_ws"):
        return _ws_path(problem, cfg, lambdas, method)
    if method == "admm":
        from convex_optimization_tpu_torch.api import ADMM_FENCE_DIM

        if min(problem.m, problem.n) > ADMM_FENCE_DIM \
                and admm_setup != "host":
            warnings.warn(
                f"lambda_path(method='admm') at min(m, n) > "
                f"{ADMM_FENCE_DIM}: a float32 eigh stalls ~1e-2 rel gap "
                "(measured by the JAX package) — falling back to the FISTA "
                "path.  Pass admm_setup='host' for the float64 host eigh.",
                stacklevel=3)
            return _fista_path(problem, cfg, lambdas, "fista")
        return _admm_path(problem, cfg, lambdas, admm_setup)
    return _sequential_path(problem, cfg, lambdas, method)


def _path_result(cfg: SolverConfig, lambdas: torch.Tensor, xs, gaps, iters,
                 method: str, kept=None, histories=None) -> PathResult:
    dev = lambdas.device
    gaps_t = torch.tensor(gaps, dtype=lambdas.dtype, device=dev)
    return PathResult(
        lambdas=lambdas, xs=torch.stack(xs), gaps=gaps_t,
        iters=torch.tensor(iters, dtype=torch.int64, device=dev),
        method_used=method, converged=gaps_t <= cfg.tol,
        sweeps=sum(iters),
        kept=(None if kept is None
              else torch.tensor(kept, dtype=torch.int64, device=dev)),
        histories=histories)


def _fista_path(problem: Problem, cfg: SolverConfig, lambdas: torch.Tensor,
                method: str) -> PathResult:
    """The JAX package's FISTA path (its ``lambda_path.py:303-317``): one
    L_total, each point warm-started at the previous point's last iterate
    with the residual from K2; returns the last iterates and their
    gaps.  Spans: ``cot.setup``, then per point ``cot.point`` around its
    warm start and its ``cot.loop``."""
    with span("cot.setup"):
        L_total = float(spectral_norm_sq_t(problem.A_t)) + problem.lam2
        col_norms = fista_mod.screen_norms(problem, cfg, None)
    xs, gaps, iters = [], [], []
    x_warm = None
    for i, lam in enumerate(lambdas.tolist()):
        with span("cot.point", index=i):
            p = problem.with_lam1(lam)
            state = fista_mod.init_state(p, None)
            if x_warm is not None:
                r_w = ax_minus_b_t(p.A_t, x_warm, p.b)
                state = state._replace(x=x_warm, r=r_w, x_prev=x_warm,
                                       r_prev=r_w, x_best=x_warm)
            with span("cot.loop") as loop:
                state = fista_mod.fista(p, L_total, state, cfg, col_norms)
            loop.set(iterations=state.k)
        x_warm = state.x
        xs.append(state.x)
        gaps.append(state.rel_gap)
        iters.append(state.k)
    return _path_result(cfg, lambdas, xs, gaps, iters, method)


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
    with span("cot.setup"):
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
        with span("cot.loop") as loop:
            state = bcd_mod.bcd(p, block_L, state, cfg, col_norms)
        loop.set(iterations=state.k)
        x_warm = state.x_best
        xs.append(state.x_best)
        gaps.append(state.best_rel_gap)
        iters.append(state.k)
    return _path_result(cfg, lambdas, xs, gaps, iters, method)


def _ws_path(problem: Problem, cfg: SolverConfig, lambdas: torch.Tensor,
             method: str) -> PathResult:
    """The JAX package's working-set path (its ``lambda_path.py:146-174``):
    one route for the whole path (L_total, column norms, and K4's
    constants for 'bcd_ws'), each point warm-started at the previous
    point's x; ``kept`` is each point's last working set."""
    inner = "bcd" if method == "bcd_ws" else "fista"
    route = ws.make_ws_route(problem, inner)
    xs, gaps, iters, kept = [], [], [], []
    x_warm = None
    for lam in lambdas.tolist():
        x, info, meta = ws.solve_working_set(
            problem.with_lam1(lam), cfg, x0=x_warm, inner=inner, route=route)
        x_warm = x
        xs.append(x)
        gaps.append(float(info.rel_gap))
        iters.append(meta["inner_iters"])
        kept.append(meta["ws_size"])
    return _path_result(cfg, lambdas, xs, gaps, iters, method, kept)


def _admm_path(problem: Problem, cfg: SolverConfig, lambdas: torch.Tensor,
               setup: str) -> PathResult:
    """The JAX package's ADMM path (its ``lambda_path.py:176-222``): one
    factorisation serves every point (it does not depend on lam1); each
    point starts at the previous point's best z and its balanced rho
    (the first at rho = max(lam1, 1e-6))."""
    from convex_optimization_tpu_torch.solvers import admm as admm_mod

    fac = admm_mod.factorize(problem, setup)
    xs, gaps, iters = [], [], []
    x_warm = rho_warm = None
    for lam in lambdas.tolist():
        p = problem.with_lam1(lam)
        state = admm_mod.admm(p, fac, admm_mod.init_state(p, x_warm,
                                                          rho0=rho_warm),
                              cfg)
        x_warm, rho_warm = state.x_best, state.rho
        xs.append(state.x_best)
        gaps.append(state.best_rel_gap)
        iters.append(state.k)
    return _path_result(cfg, lambdas, xs, gaps, iters, "admm")


def _bucket(k: int, n: int) -> int:
    """The kept count rounded up to a bucket (smaller buckets for small
    problems, so that compaction still bites)."""
    bucket = min(512, max(64, n // 8))
    return min(n, -(-max(k, 1) // bucket) * bucket)


def _compact_path(problem: Problem, cfg: SolverConfig,
                  lambdas: torch.Tensor) -> PathResult:
    """The JAX package's compacting path (its ``lambda_path.py:319-413``).
    At each point a gap-safe screen at the warm start (r by K2, the
    witness by K3, on the full ``A_t``), its gap inflated by gamma =
    (ceil(log2 m) + 4) eps32 |P| for the witness's rounding and its radius
    cushioned by the solved point's own gap (sqrt(2 tol |P| 1.5)), so the
    compact certificate holds for the full problem; whole groups by the
    group sphere test.  The kept columns, padded to a bucket by the
    lowest unused columns (groups), are gathered into a slab and solved by
    FISTA with the full L_total, then scattered back.  Returns the last
    iterates and their gaps, as the FISTA path does."""
    n, m, dev = problem.n, problem.m, problem.device
    pen = problem.penalty
    is_group = pen.kind == "group_l2"
    gsize = n // pen.ngroups if is_group else 1
    ngroups = n // gsize
    gw = pen._gweights(problem.dtype, dev) if is_group else None
    L_total = float(spectral_norm_sq_t(problem.A_t)) + problem.lam2
    col_norms = problem.col_norms()
    gcol = (torch.sqrt(torch.sum(col_norms.reshape(ngroups, gsize) ** 2,
                                 dim=1)) if is_group else None)
    eps = float(np.finfo(np.float32).eps)
    gamma = (math.ceil(math.log2(max(m, 2))) + 4) * eps
    x_warm = torch.zeros((n,), dtype=problem.dtype, device=dev)
    xs, gaps, iters, kept = [], [], [], []
    for lam in lambdas.tolist():
        p = problem.with_lam1(lam)
        r = ax_minus_b_t(p.A_t, x_warm, p.b)
        z = neg_at_r_t(p.A_t, r, x_warm, p.lam2)
        info = duality_gap(p, x_warm, r, z=z)
        r_norm = torch.linalg.vector_norm(r)
        gap_safe = 1.25 * torch.abs(info.gap) + gamma * torch.abs(info.primal)
        radius = (torch.sqrt(2.0 * gap_safe)
                  + torch.sqrt(2.0 * cfg.tol * torch.abs(info.primal) * 1.5))
        if is_group:
            gn = torch.linalg.vector_norm(
                (info.alpha * z).reshape(ngroups, gsize), dim=1)
            gmargin = info.alpha * gamma * r_norm * gcol
            gkeep = ~(gn + gmargin + radius * gcol < lam * gw)
            keep = torch.repeat_interleave(gkeep, gsize)
        else:
            witness = (torch.abs(info.alpha * z)
                       + info.alpha * gamma * col_norms * r_norm)
            keep = ~(witness + radius * col_norms < lam)
        idx = np.nonzero(keep.cpu().numpy())[0]
        # the bucket in whole groups, padded by the lowest unused ones
        k_b = -(-_bucket(len(idx), n) // gsize) * gsize
        keep = np.zeros((n,), dtype=bool)
        keep[ws.pad_to(idx, k_b, n, gsize)] = True
        p_small, idx_t = compact_problem(p, keep)
        x_small = x_warm.index_select(0, idx_t)
        # the warm start may be nonzero off the kept columns: its residual
        # on the slab is K2's on the slab
        state = fista_mod.init_state(
            p_small, x_small, r0=ax_minus_b_t(p_small.A_t, x_small, p.b))
        state = fista_mod.fista(
            p_small, L_total, state, cfg,
            col_norms.index_select(0, idx_t) if cfg.screen_every > 0
            else None)
        x_warm = torch.zeros((n,), dtype=problem.dtype,
                             device=dev).index_copy_(0, idx_t, state.x)
        xs.append(x_warm)
        gaps.append(state.rel_gap)
        iters.append(state.k)
        kept.append(int(idx_t.numel()))
    return _path_result(cfg, lambdas, xs, gaps, iters,
                        "fista_compact", kept)


def _sharded_path(problem: Problem, cfg: SolverConfig, g, path_len: int,
                  lam_min_frac: float, lambdas, method: str) -> PathResult:
    """The JAX package's sharded sequential path (its
    ``lambda_path.py:416-525``, the column and row layouts): the sharded
    set-up once (``parallel/sharded.prepare_sharded``), then each point
    from the previous point's best iterate on the slab, with a fresh
    residual (K2 on the slab, and a psum on the column layout), the
    counters and the keep mask reset.  As in
    the JAX package, 'ista' sets no momentum=False and the BCD methods
    differ in ``use_pallas``.  The stop decisions inside each point are
    rank 0's (``_gap_check_local``), so every rank leaves every point at
    the same check."""
    from convex_optimization_tpu_torch.parallel import sharded as sh

    if method not in ("fista", "ista", "bcd", "bcd_pallas"):
        raise ValueError(
            f"sharded lambda_path supports 'fista'/'ista'/'bcd'/"
            f"'bcd_pallas' (and 'bcd_batch' via its own route); "
            f"got {method!r}")
    is_bcd = method in ("bcd", "bcd_pallas")
    if is_bcd:
        cfg = dataclasses.replace(cfg, use_pallas=(method == "bcd_pallas"))
    setup = sh.prepare_sharded(problem, "bcd" if is_bcd else "fista", cfg,
                               g)
    dev = g.device
    if lambdas is None:
        lmax = sh.sharded_lambda_max(setup.loc, g)
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype, dev)
    lambdas = torch.as_tensor(lambdas, dtype=problem.dtype, device=dev)
    xs, gaps, iters, hists = [], [], [], []
    x_warm = None
    for lam in lambdas.tolist():
        state = sh.run_sharded(setup, sh.sharded_state(setup, g, x_warm), g,
                               lam)
        x_warm = state.x_best
        xs.append(sh.gather_x(state.x_best, g))
        gaps.append(state.best_rel_gap)
        iters.append(state.k)
        hists.append(state.history.trimmed())
    return _path_result(cfg, lambdas, xs, gaps, iters, f"{method}+sharded",
                        histories=hists)
