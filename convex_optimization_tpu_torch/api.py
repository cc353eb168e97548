"""User-facing API: ``solve(problem, method=...) -> Result``.

Counterpart of ``convex_optimization_tpu/api.py``: every single-device
method (``bcd``, ``bcd_pallas``, ``fista``, ``ista``, ``admm`` and the
working-set ``fista_ws`` / ``bcd_ws``), the column-sharded solvers
(``mesh=``, a ``parallel.mesh.ColumnGroup``) and the f64 certify phase.
The relay timing protocol of the JAX package (a warm run, then a perturbed
timed run) has no reason to exist here: the kernels are built and loaded
before the clock starts, and the one solve is timed between
``torch.cuda.synchronize()`` calls.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Optional

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
from convex_optimization_tpu_torch.ops.matvec import (
    block_power_t,
    block_power_t_plain,
    spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.utils.device import sync as _sync

#: ADMM's scale fence: above this min(m, n) the JAX package measured the
#: float32 eigh of an ill-conditioned Gram stalling the solve near 1e-2
#: rel gap (its ``api.py:33-37``); ``admm_force=True`` or
#: ``admm_setup="host"`` (a float64 eigh) passes it.  A module constant,
#: so tests can lower it.
ADMM_FENCE_DIM = 4096


@dataclasses.dataclass
class Result:
    x: torch.Tensor          # float64 after an f64 certify phase
    gap: float               # absolute duality gap at the best check
    rel_gap: float           # relative duality gap (the convergence criterion)
    primal: float
    iterations: int          # sweeps or FISTA steps, all in wall_time_s
    converged: bool
    wall_time_s: float       # solve wall clock (excludes build and set-up)
    history: dict            # convergence history (numpy arrays)
    method: str
    config: SolverConfig
    setup_time_s: float = 0.0   # Lipschitz constants (K4, or L_total)
    screened: int = 0        # coordinates the last check's gap-safe screen
                             # froze (screen_every > 0; not in the JAX package)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.x))


def _pad_columns(problem: Problem, pad: int) -> Problem:
    """Append ``pad`` zero columns (one copy of A_t).  Padded coordinates
    are zero at every optimum; the solver also freezes them by mask."""
    n, m = problem.n, problem.m
    A_rows = torch.zeros((n + pad, m), dtype=problem.dtype,
                         device=problem.device)
    A_rows[:n] = problem.A_rows
    pen = problem.penalty
    if pen.kind == "group_l2":
        gsize = n // pen.ngroups
        if pad % gsize:
            raise ValueError("padding must be whole groups")
        extra = pad // gsize
        w = pen.weights
        if w is not None:
            w = torch.cat([w, torch.ones((extra,), dtype=w.dtype,
                                         device=w.device)])
        pen = dataclasses.replace(pen, ngroups=pen.ngroups + extra, weights=w)
    return dataclasses.replace(problem, A_t=A_rows.view(n + pad, 1, m),
                               penalty=pen)


def solve(problem: Problem, method: str = "fista", *,
          x0: Optional[torch.Tensor] = None,
          cfg: Optional[SolverConfig] = None,
          mesh=None,
          certify: bool = False,
          **cfg_overrides: Any) -> Result:
    """Solve a composite problem on the device of ``problem.A_t``.

    method: 'fista' (the default, as in the JAX package) or 'ista' (K2/K3
    steps), 'bcd_pallas' (K1 or K9, K2-K4: the CUDA kernels for a CUDA
    problem, their plain versions for a CPU problem), 'bcd' (the plain
    reference sweep), 'fista_ws' / 'bcd_ws' (the working-set outer loop,
    ``solvers/working_set.py``), 'admm' (``solvers/admm.py``: pass
    ``admm_setup="host"`` for the float64 host eigh, ``admm_force=True``
    to run the device set-up above ``ADMM_FENCE_DIM``, where it otherwise
    warns and falls back to 'fista'); 'bcd_batch' solves a grid and is
    reached through ``lambda_path``.  With ``mesh`` (a
    ``parallel.mesh.ColumnGroup``) every rank of the group calls this with
    the same problem and solves its column slab on the group's device
    (``parallel/sharded.py``).  ``certify=True`` finishes with the f64
    polish when the f32 solve stopped above tol.  Extra kwargs override
    SolverConfig fields."""
    if method == "bcd_batch":
        raise ValueError(
            "method 'bcd_batch' solves a LAMBDA GRID, not a single point — "
            "use lambda_path(problem, cfg, method='bcd_batch')")
    if method not in ("bcd", "bcd_pallas", "fista", "ista", "fista_ws",
                      "bcd_ws", "admm"):
        raise ValueError(f"unknown method {method!r}")
    if mesh is not None:
        from convex_optimization_tpu_torch.parallel.sharded import (
            solve_sharded,
        )

        res = solve_sharded(problem, method, mesh, x0=x0, cfg=cfg,
                            **cfg_overrides)
        return _maybe_certify(problem, res, certify)
    cfg = SolverConfig() if cfg is None else cfg
    if method == "ista":
        cfg_overrides.setdefault("momentum", False)
    if method == "bcd_pallas":
        cfg_overrides.setdefault("use_pallas", True)
    admm_force = bool(cfg_overrides.pop("admm_force", False))
    admm_setup = cfg_overrides.pop("admm_setup", "device")
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if method == "admm" and (min(problem.m, problem.n) > ADMM_FENCE_DIM
                             and not admm_force and admm_setup != "host"):
        warnings.warn(
            f"admm at min(m, n) > {ADMM_FENCE_DIM} stalls ~1e-2 rel gap "
            "(float32 eigh accuracy, measured by the JAX package) — falling "
            "back to FISTA.  Pass admm_force=True to run ADMM anyway, or "
            "admm_setup='host' for the float64 host eigh.", stacklevel=2)
        return solve(problem, "fista", x0=x0, cfg=cfg, certify=certify)
    if method in ("fista", "ista"):
        res = _solve_fista(problem, method, x0, cfg)
    elif method in ("fista_ws", "bcd_ws"):
        res = _solve_ws(problem, method, x0, cfg)
    elif method == "admm":
        res = _solve_admm(problem, x0, cfg, admm_setup)
    else:
        res = _solve_bcd(problem, method, x0, cfg)
    return _maybe_certify(problem, res, certify)


def _solve_ws(problem: Problem, method: str, x0, cfg: SolverConfig
              ) -> Result:
    """The working-set solver: the route (L_total, column norms and, for
    'bcd_ws', K4's constants) is set-up; the wall counts the rest.
    ``history`` carries the solver's meta."""
    from convex_optimization_tpu_torch.solvers import working_set as ws

    device = problem.device
    if device.type == "cuda":
        _build.load()
    inner = "bcd" if method == "bcd_ws" else "fista"
    _sync(device)
    t0 = time.perf_counter()
    route = ws.make_ws_route(problem, inner)
    _sync(device)
    setup_s = time.perf_counter() - t0
    x, info, meta = ws.solve_working_set(problem, cfg, x0=x0, inner=inner,
                                         route=route)
    rel = float(info.rel_gap)
    return Result(x=x, gap=float(info.gap), rel_gap=rel,
                  primal=float(info.primal), iterations=meta["inner_iters"],
                  converged=rel <= cfg.tol, wall_time_s=meta["wall_s"],
                  history=meta, method=method, config=cfg,
                  setup_time_s=setup_s)


def _solve_admm(problem: Problem, x0, cfg: SolverConfig, setup: str
                ) -> Result:
    """ADMM: the factorisation (``admm.factorize``: its eigh on the device,
    or in f64 on the host) is set-up; the wall counts the loop.
    ``history`` holds the checks and the set-up's parts (``gram_s``,
    ``eigh_s``)."""
    from convex_optimization_tpu_torch.solvers import admm as admm_mod

    device = problem.device
    if device.type == "cuda":
        _build.load()
    _sync(device)
    t0 = time.perf_counter()
    fac = admm_mod.factorize(problem, setup)
    state0 = admm_mod.init_state(problem, x0)
    _sync(device)
    t1 = time.perf_counter()
    final = admm_mod.admm(problem, fac, state0, cfg)
    _sync(device)
    wall = time.perf_counter() - t1
    return Result(x=final.x_best, gap=final.best_gap,
                  rel_gap=final.best_rel_gap, primal=final.best_primal,
                  iterations=final.k,
                  converged=final.best_rel_gap <= cfg.tol, wall_time_s=wall,
                  history={**final.history.trimmed(), **fac.setup_s},
                  method="admm", config=cfg, setup_time_s=t1 - t0)


def _solve_fista(problem: Problem, method: str, x0, cfg: SolverConfig
                 ) -> Result:
    """FISTA/ISTA with L_total = ||A||^2 + lam2 by the K2/K3 power
    iteration (set-up, outside the solve wall, as are the column norms
    that screening reads)."""
    device = problem.device
    if device.type == "cuda":
        _build.load()
    _sync(device)
    t0 = time.perf_counter()
    L_total = float(spectral_norm_sq_t(problem.A_t)) + problem.lam2
    col_norms = fista_mod.screen_norms(problem, cfg, None)
    _sync(device)
    setup_s = time.perf_counter() - t0
    state0 = fista_mod.init_state(problem, x0)
    _sync(device)
    t1 = time.perf_counter()
    final = fista_mod.fista(problem, L_total, state0, cfg, col_norms)
    _sync(device)
    return _result(final, method, cfg, time.perf_counter() - t1, setup_s)


def _result(final, method: str, cfg: SolverConfig, wall: float,
            setup_s: float, n: int | None = None) -> Result:
    """Result from a final state: the best-certified iterate (cut to the
    first ``n`` coordinates when given) and its check's numbers."""
    keep = final.keep_mask if n is None else final.keep_mask[:n]
    return Result(
        x=final.x_best if n is None else final.x_best[:n],
        gap=final.best_gap,
        rel_gap=final.best_rel_gap,
        primal=final.best_primal,
        iterations=final.k,
        converged=final.best_rel_gap <= cfg.tol,
        wall_time_s=wall,
        history=final.history.trimmed(),
        method=method,
        config=cfg,
        setup_time_s=setup_s,
        screened=(int(keep.numel() - keep.sum()) if cfg.screen_every > 0
                  else 0),
    )


def _solve_bcd(problem: Problem, method: str, x0, cfg: SolverConfig
               ) -> Result:
    device = problem.device
    orig_n = problem.n
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    base_mask = None
    if cfg.use_pallas:
        bs, pad = pick_block_size_t(problem.n, cfg.block_size, multiple)
    else:
        bs = bcd_mod.pick_block_size(problem.n, cfg.block_size,
                                     multiple_of=multiple)
        pad = 0
    if pad:
        problem = _pad_columns(problem, pad)
        base_mask = torch.arange(problem.n, device=device) < orig_n
        if x0 is not None:
            x0 = torch.nn.functional.pad(x0, (0, pad))
    problem = problem.with_block(bs)

    if cfg.use_pallas:
        bcd_mod.prepare_sweep(problem.A_t)

    _sync(device)
    t0 = time.perf_counter()
    block_L = (block_power_t(problem.A_t) if cfg.use_pallas
               else block_power_t_plain(problem.A_t))
    col_norms = bcd_mod.screen_norms(problem, cfg, None)
    _sync(device)
    setup_s = time.perf_counter() - t0

    state0 = bcd_mod.init_state(problem, x0, keep_mask=base_mask)
    _sync(device)
    t1 = time.perf_counter()
    final = bcd_mod.bcd(problem, block_L, state0, cfg, col_norms)
    _sync(device)
    return _result(final, method, cfg, time.perf_counter() - t1, setup_s,
                   orig_n)


def _maybe_certify(problem: Problem, res: Result, certify: bool) -> Result:
    """certify=True: if the f32 solve stopped above tol, finish with the
    f64 polish and fold its certificate into the Result (x becomes the
    polish's float64 iterate, on the problem's device)."""
    if not certify or (res.converged and res.rel_gap <= res.config.tol):
        return res
    from convex_optimization_tpu_torch.solvers.polish import polish_support

    pr = polish_support(problem, res.x, tol=res.config.tol)
    return dataclasses.replace(
        res, x=torch.from_numpy(pr.x).to(problem.device),
        gap=pr.gap, rel_gap=pr.rel_gap, primal=pr.primal,
        converged=pr.rel_gap <= res.config.tol,
        wall_time_s=res.wall_time_s + pr.wall_time_s)
