"""Shared solver plumbing: config, state, and the convergence history.

Counterpart of ``convex_optimization_tpu/solvers/common.py``.  The JAX
package records checks into fixed-size device buffers inside one jitted
while_loop; here the loop runs on the host and syncs once per check, so
the history is host lists and the check scalars in the state are Python
floats.  The stall and best-iterate rules of ``record_check`` are
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver knobs: the JAX package's SolverConfig minus
    ``unroll_checks``, an XLA:CPU workaround with no counterpart here."""

    max_iters: int = 2000
    tol: float = 1e-6          # relative duality-gap target (the 1e-6 grade)
    gap_every: int = 10        # convergence check cadence (iters or sweeps)
    momentum: bool = True      # FISTA (True) vs ISTA (False)
    adaptive_restart: bool = True
    block_size: int = 256      # BCD column-block width
    step_scale: float = 1.0    # BCD step damping
    use_pallas: bool = False   # BCD: device kernels vs plain sweep
    screen_every: int = 0      # 0 = screening off; else gap-safe screening
                               # at every check (the JAX package's rule)
    stall_checks: int = 0      # 0 = off; else exit after this many gap
                               # checks without a new best rel_gap
    consensus: str = "psum"    # column-sharded residual consensus: "psum",
                               # "ring" or "reduce_scatter"
                               # (parallel/collectives.py)


@dataclasses.dataclass
class History:
    """Convergence history recorded at gap checks (host lists)."""

    iteration: list = dataclasses.field(default_factory=list)
    primal: list = dataclasses.field(default_factory=list)
    dual: list = dataclasses.field(default_factory=list)
    gap: list = dataclasses.field(default_factory=list)
    rel_gap: list = dataclasses.field(default_factory=list)
    nnz: list = dataclasses.field(default_factory=list)

    def record(self, iteration, primal, dual, gap, rel_gap, nnz) -> None:
        self.iteration.append(int(iteration))
        self.primal.append(primal)
        self.dual.append(dual)
        self.gap.append(gap)
        self.rel_gap.append(rel_gap)
        self.nnz.append(int(nnz))

    def trimmed(self) -> dict:
        """dict of numpy arrays (the JAX History.trimmed() layout)."""
        return {
            "iteration": np.asarray(self.iteration, np.int32),
            "primal": np.asarray(self.primal, np.float64),
            "dual": np.asarray(self.dual, np.float64),
            "gap": np.asarray(self.gap, np.float64),
            "rel_gap": np.asarray(self.rel_gap, np.float64),
            "nnz": np.asarray(self.nnz, np.int32),
        }


class SolveState(NamedTuple):
    """Solver carry: device tensors plus the last check's host scalars.
    The FISTA momentum fields (x_prev, r_prev, t_mom: a 0-d tensor on the
    device, so that the restart test needs no host sync) stay at their
    start values in BCD."""

    x: torch.Tensor
    r: torch.Tensor          # A x - b, maintained incrementally or refreshed
    k: int                   # iteration counter
    rel_gap: float           # most recent relative duality gap
    gap: float
    primal: float
    keep_mask: torch.Tensor  # (n,) bool screening mask (all True if unused)
    history: History
    best_rel_gap: float      # best rel_gap seen at any check
    stall: int               # consecutive checks without improvement
    x_best: torch.Tensor     # iterate at the best check
    best_gap: float
    best_primal: float
    x_prev: torch.Tensor | None = None
    r_prev: torch.Tensor | None = None
    t_mom: torch.Tensor | None = None


def count_nnz(x: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(x)


def record_check(state: SolveState, info: dict, x_for_best: torch.Tensor,
                 nnz: int, keep: torch.Tensor) -> SolveState:
    """Gap-check bookkeeping: history record, screening mask, stall
    counter, best-iterate tracking.  ``info`` holds the check's host
    floats (gap, primal, dual, rel_gap)."""
    state.history.record(state.k, info["primal"], info["dual"], info["gap"],
                         info["rel_gap"], nnz)
    improved = info["rel_gap"] < state.best_rel_gap
    return state._replace(
        rel_gap=info["rel_gap"], gap=info["gap"], primal=info["primal"],
        keep_mask=keep,
        best_rel_gap=min(info["rel_gap"], state.best_rel_gap),
        stall=0 if improved else state.stall + 1,
        x_best=x_for_best.clone() if improved else state.x_best,
        best_gap=info["gap"] if improved else state.best_gap,
        best_primal=info["primal"] if improved else state.best_primal,
    )
