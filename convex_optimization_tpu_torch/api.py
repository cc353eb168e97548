"""User-facing API: ``solve(problem, method=...) -> Result``.

Counterpart of ``convex_optimization_tpu/api.py`` for the ``bcd`` and
``bcd_pallas`` methods (``api.py:246-330, 405-430`` there).  The relay
timing protocol of the JAX package (a warm run, then a perturbed timed
run) has no reason to exist here: the kernels are built and loaded before
the clock starts, and the one solve is timed between
``torch.cuda.synchronize()`` calls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    pick_block_size_t,
    sweep_grid,
)
from convex_optimization_tpu_torch.ops.matvec import (
    block_power_t,
    block_power_t_plain,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers.common import (
    NOT_PORTED,
    SolverConfig,
)


@dataclasses.dataclass
class Result:
    x: torch.Tensor
    gap: float               # absolute duality gap at the best check
    rel_gap: float           # relative duality gap (the convergence criterion)
    primal: float
    iterations: int          # BCD sweeps, all within wall_time_s
    converged: bool
    wall_time_s: float       # solve wall clock (excludes build and set-up)
    history: dict            # convergence history (numpy arrays)
    method: str
    config: SolverConfig
    setup_time_s: float = 0.0   # per-block Lipschitz constants (K4)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.x))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def solve(problem: Problem, method: str = "bcd_pallas", *,
          x0: Optional[torch.Tensor] = None,
          cfg: Optional[SolverConfig] = None,
          **cfg_overrides: Any) -> Result:
    """Solve a composite problem on the device of ``problem.A_t``.

    method: 'bcd_pallas' (K1-K4: the CUDA kernels for a CUDA problem,
    their plain versions for a CPU problem) or 'bcd' (the plain reference
    sweep); 'bcd_batch' solves a grid and is reached through
    ``lambda_path``.  Extra kwargs override SolverConfig fields."""
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet "
            f"(ROADMAP {NOT_PORTED[method]})")
    if method == "bcd_batch":
        raise ValueError(
            "method 'bcd_batch' solves a LAMBDA GRID, not a single point — "
            "use lambda_path(problem, cfg, method='bcd_batch')")
    if method not in ("bcd", "bcd_pallas"):
        raise ValueError(f"unknown method {method!r}")
    cfg = SolverConfig() if cfg is None else cfg
    if method == "bcd_pallas":
        cfg_overrides.setdefault("use_pallas", True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)

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

    if cfg.use_pallas and device.type == "cuda":
        _build.load()
        if problem.penalty.kind != "group_l2":
            sweep_grid(device, bs, problem.m)

    _sync(device)
    t0 = time.perf_counter()
    block_L = (block_power_t(problem.A_t) if cfg.use_pallas
               else block_power_t_plain(problem.A_t))
    _sync(device)
    setup_s = time.perf_counter() - t0

    state0 = bcd_mod.init_state(problem, x0, keep_mask=base_mask)
    _sync(device)
    t1 = time.perf_counter()
    final = bcd_mod.bcd(problem, block_L, state0, cfg)
    _sync(device)
    wall = time.perf_counter() - t1

    x_out = final.x_best[:orig_n]
    return Result(
        x=x_out,
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
    )
