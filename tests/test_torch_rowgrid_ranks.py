"""Rank-side jobs of the row- and grid-sharded tests
(tests/test_torch_row_sharded.py, tests/test_torch_grid_sharded.py),
run by the port's launcher ``parallel.launch.run_ranks``.  Spawned ranks
import this module, so it imports neither jax nor the JAX package; it
holds no tests.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def layout_group(g, layout: tuple):
    """The group of ``layout`` over the ranks of ``g``: ("rows",) for a
    RowGroup, ("grid", R, C) for a GridGroup."""
    from convex_optimization_tpu_torch.parallel.mesh import (
        grid_group,
        row_group,
    )

    if layout[0] == "rows":
        return row_group(g.device)
    return grid_group(layout[1], layout[2], g.device)


def _fed(grp, problem, run: dict) -> dict:
    """The row or grid solver of ``run`` fed its L_total or block_L (the
    full array, as the JAX solvers take it) at ``run["block"]``."""
    from convex_optimization_tpu_torch.parallel import grid_sharded as gs
    from convex_optimization_tpu_torch.parallel import row_sharded as rs
    from convex_optimization_tpu_torch.parallel.mesh import ROWS
    from convex_optimization_tpu_torch.parallel.sharded import gather_x
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.solvers.fista import init_state

    cfg = SolverConfig(**run["cfg"])
    rows = grp.axis == ROWS
    block = run.get("block") or (problem.n if rows
                                 else problem.n // grp.blocks.size)
    loc = (rs.shard_rows(problem, grp, block) if rows
           else gs.shard_grid(problem, grp, block))
    norms = None
    if cfg.screen_every > 0:
        norms = rs.global_col_norms(loc, grp if rows else grp.rows)
    state = init_state(loc, None)
    if run["method"] == "fista":
        solver = rs.sharded_fista_rows if rows else gs.grid_sharded_fista
        final = solver(loc, run["L_total"], state, cfg, grp, norms)
    else:
        bl = torch.as_tensor(run["block_L"])
        if not rows:
            nb = loc.n // block
            bl = bl[grp.blocks.rank * nb:(grp.blocks.rank + 1) * nb]
        solver = rs.sharded_bcd_rows if rows else gs.grid_sharded_bcd
        final = solver(loc, bl.to(loc.device), state, cfg, grp, norms)
    return dict(x=_np(gather_x(final.x_best, grp)),
                keep=_np(gather_x(final.keep_mask.float(), grp)) > 0,
                history=final.history.trimmed(), k=final.k,
                rel_gap=final.best_rel_gap,
                converged=final.best_rel_gap <= cfg.tol)


def _run_all(grp, A: np.ndarray, b: np.ndarray, runs: list) -> list:
    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.core.problem import problem_from_numpy
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.solvers.lambda_path import lambda_path

    out = []
    for run in runs:
        problem = problem_from_numpy(A, b, device="cpu", **run["pen"])
        _build.reset_launches()
        if run["kind"] == "fed":
            res = _fed(grp, problem, run)
        elif run["kind"] == "api":
            r = solve(problem, run["method"], mesh=grp, **run["cfg"])
            res = dict(x=_np(r.x), history=r.history, k=r.iterations,
                       rel_gap=r.rel_gap, converged=r.converged,
                       method=r.method, screened=r.screened)
        else:
            pr = lambda_path(problem, SolverConfig(**run["cfg"]), mesh=grp,
                             **run["kw"])
            res = dict(lambdas=_np(pr.lambdas), xs=_np(pr.xs),
                       gaps=_np(pr.gaps), iters=_np(pr.iters),
                       converged=_np(pr.converged),
                       method_used=pr.method_used, histories=pr.histories)
        res["launches"] = dict(_build.launches)
        out.append(res)
    return out


def layouts_job(g, layout: tuple, jobs: list) -> list:
    """Runs on the row or grid ``layout`` (``layout_group``) of several
    problems: ``jobs`` holds ((A, b), runs) pairs, A a CPU view.  ``runs``:
    dicts with the penalty ``pen`` (``problem_from_numpy``'s arguments), a
    ``kind`` and:
      * "fed": ``method`` ("fista" or "bcd"), the SolverConfig fields
        ``cfg``, ``L_total`` or ``block_L`` and ``block``;
      * "api": ``solve(mesh=group, method=..., **cfg)``;
      * "path": ``lambda_path(mesh=group, **kw)`` with SolverConfig(**cfg).
    Returns per job, per run, the gathered x (the path: xs and its
    numbers), the history and this rank's launch counts."""
    grp = layout_group(g, layout)
    return [_run_all(grp, A, b, runs) for (A, b), runs in jobs]


def run_layout(layout: tuple, P: int, tmp_dir, jobs: list) -> list:
    """``layouts_job`` on P gloo ranks on the CPU; rank 0's results, in
    the order of the runs of ``jobs`` flattened, after checking that every
    rank returned the same x (or xs)."""
    from test_torch_sharded_ranks import run_cpu_ranks

    ranks = run_cpu_ranks(layouts_job, P, tmp_dir, layout, jobs)
    flat = [[res for job in rank for res in job] for rank in ranks]
    for other in flat[1:]:
        for mine, theirs in zip(flat[0], other):
            for key in ("x", "xs"):
                if key in mine:
                    np.testing.assert_array_equal(theirs[key], mine[key])
    return flat[0]
