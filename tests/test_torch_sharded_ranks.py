"""Rank-side jobs of the column-sharded tests (tests/test_torch_sharded.py
on the CPU, tests/test_torch_cuda.py on the card), run by the port's
launcher ``parallel.launch.run_ranks``.  Spawned ranks import this module,
so it imports neither jax nor the JAX package; it holds no tests.
"""

from __future__ import annotations

import numpy as np
import torch

from convex_optimization_tpu_torch.parallel.launch import run_ranks

#: a rank of these small jobs takes seconds; a hang is killed at this
JOIN_TIMEOUT_S = 240.0


def run_cpu_ranks(job, P: int, tmp_dir, *args) -> list:
    """``job`` on P gloo ranks on the CPU, one torch thread each."""
    return run_ranks(job, P, tmp_dir, *args, device="cpu", backend="gloo",
                     timeout_s=JOIN_TIMEOUT_S, collective_timeout_s=60.0,
                     threads=1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def collectives_job(g, vectors: list) -> dict:
    """Every consensus collective of this rank's vector in each pair of
    ``vectors`` (one (P, len) array per length) against ``psum``."""
    from convex_optimization_tpu_torch.parallel import collectives as c

    out = {}
    for v in vectors:
        x = torch.from_numpy(v[g.rank]).to(g.device)
        out[len(x)] = {
            "psum": _np(c.psum(x.clone(), g)),
            "ring": _np(c.ring_psum(x, g)),
            "ring_async": _np(c.ring_psum(x, g, async_op=True).wait()),
            "ring_chunked": _np(c.ring_psum_chunked(x, g, 2)),
            "reduce_scatter": _np(c.reduce_scatter_gather(x, g)),
            "pmax": _np(c.pmax(x.clone(), g)),
            "input_kept": bool(torch.equal(x, torch.from_numpy(
                v[g.rank]).to(g.device))),
        }
    return out


def card_collectives_job(g) -> dict:
    """Each collective on this rank's vector v_r = base + r / 2 (on
    ``g.device``): its largest distance from the exact result, or the
    error the backend raised for it (an op it refuses must raise alike on
    every rank, not hang)."""
    from convex_optimization_tpu_torch.parallel import collectives as c

    base = torch.arange(4 * g.size, dtype=torch.float32, device=g.device)
    v = base + 0.5 * g.rank
    P = g.size
    total = P * base + 0.25 * P * (P - 1)
    want = {"psum": total, "ring": total, "reduce_scatter": total,
            "pmax": base + 0.5 * (P - 1), "broadcast0": base,
            "all_gather": torch.cat([base + 0.5 * r for r in range(P)])}
    ops = {"psum": lambda: c.psum(v.clone(), g),
           "pmax": lambda: c.pmax(v.clone(), g),
           "broadcast0": lambda: c.broadcast0(v.clone(), g),
           "all_gather": lambda: c.all_gather(v, g),
           "reduce_scatter": lambda: c.reduce_scatter_gather(v, g),
           "ring": lambda: c.ring_psum(v, g),
           "psum_after": lambda: c.psum(v.clone(), g)}
    want["psum_after"] = total
    out = {}
    for name, fn in ops.items():
        try:
            out[name] = float((fn() - want[name]).abs().max())
        except Exception as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


def solve_job(g, A: np.ndarray, b: np.ndarray, pen: dict, runs: list
              ) -> list:
    """The column-sharded solvers on one problem (a CPU view of A; each
    rank uploads its slab to ``g.device``).  ``runs``: dicts with
    ``method`` ("fista" or "bcd"), the SolverConfig fields ``cfg`` and
    either ``L_total`` (FISTA) or the full ``block_L`` and ``block``
    (BCD), fed as given, or ``api=True`` for ``solve(mesh=g, ...)`` with
    ``cfg`` as keyword arguments; a run's own ``pen`` replaces ``pen``
    (``problem_from_numpy``'s arguments, ``lam2`` among them).  With
    ``screen_every > 0`` the fed runs screen with the slab's column norms.
    Returns per run the gathered x, the history, the step count and the
    launch counts of this rank, and for the fed runs the gathered keep
    mask of the last check."""
    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.core.problem import problem_from_numpy
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.parallel.collectives import all_gather
    from convex_optimization_tpu_torch.parallel.sharded import (
        shard_columns,
        sharded_bcd,
        sharded_fista,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.solvers.fista import init_state

    out = []
    for run in runs:
        problem = problem_from_numpy(A, b, device="cpu",
                                     **run.get("pen", pen))
        _build.reset_launches()
        if run.get("api"):
            res = solve(problem, run["method"], mesh=g, **run["cfg"])
            out.append(dict(x=_np(res.x), history=res.history,
                            k=res.iterations, rel_gap=res.rel_gap,
                            converged=res.converged, method=res.method,
                            launches=dict(_build.launches)))
            continue
        cfg = SolverConfig(**run["cfg"])
        if run["method"] == "fista":
            loc = shard_columns(problem, g, problem.n // g.size)
        else:
            loc = shard_columns(problem, g, run["block"])
        norms = loc.col_norms() if cfg.screen_every > 0 else None
        if run["method"] == "fista":
            final = sharded_fista(loc, run["L_total"], init_state(loc, None),
                                  cfg, g, norms)
        else:
            nb = loc.n // run["block"]
            lo = g.rank * nb
            bl = torch.as_tensor(run["block_L"][lo:lo + nb], device=g.device)
            final = sharded_bcd(loc, bl, init_state(loc, None), cfg, g,
                                norms)
        out.append(dict(x=_np(all_gather(final.x_best, g)),
                        keep=_np(all_gather(final.keep_mask.float(), g)) > 0,
                        history=final.history.trimmed(), k=final.k,
                        rel_gap=final.best_rel_gap,
                        converged=final.best_rel_gap <= cfg.tol,
                        launches=dict(_build.launches)))
    return out


def path_job(g, A: np.ndarray, b: np.ndarray, runs: list) -> list:
    """The sharded lambda paths on one problem (a CPU view of A).
    ``runs``: dicts with the penalty ``pen`` (``problem_from_numpy``'s
    arguments), the SolverConfig fields ``cfg`` and the keyword arguments
    ``kw`` of ``lambda_path(..., mesh=g)`` (``row_mask`` among them sends
    the run to ``batched_lambda_path``).  Returns per run the path's
    lambdas, xs, gaps, iters, converged flags, method_used, per-point
    histories, the warnings it raised and this rank's launch counts."""
    import warnings

    from convex_optimization_tpu_torch.core.problem import problem_from_numpy
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.batched_path import (
        batched_lambda_path,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.solvers.lambda_path import lambda_path

    out = []
    for run in runs:
        problem = problem_from_numpy(A, b, device="cpu", **run["pen"])
        cfg = SolverConfig(**run["cfg"])
        kw = dict(run["kw"])
        _build.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if "row_mask" in kw:
                kw["row_mask"] = torch.as_tensor(kw["row_mask"])
                pr = batched_lambda_path(problem, cfg, mesh=g, **kw)
            else:
                pr = lambda_path(problem, cfg, mesh=g, **kw)
        out.append(dict(lambdas=_np(pr.lambdas), xs=_np(pr.xs),
                        gaps=_np(pr.gaps), iters=_np(pr.iters),
                        converged=_np(pr.converged),
                        method_used=pr.method_used,
                        histories=pr.histories,
                        warnings=[str(w.message) for w in caught],
                        launches=dict(_build.launches)))
    return out


def solves_and_paths_job(g, solves: tuple, paths: list) -> tuple:
    """``solve_job`` on ``solves`` (its arguments after the group) and
    ``path_job`` on each of ``paths``, in one launch of the ranks."""
    return (solve_job(g, *solves),
            [path_job(g, *args) for args in paths])
