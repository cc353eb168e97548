"""The check loop and the check's end shared by the sharded solvers of
every layout (``sharded.py``'s columns, ``row_sharded.py``'s rows,
``grid_sharded.py``'s tiles).

Counterpart of the ``lax.while_loop`` over checks in each solver of
``convex_optimization_tpu/parallel/sharded.py``, ``row_sharded.py`` and
``grid_sharded.py``: there one program decides for every device; here
each rank decides, so the stop numbers come from rank 0 by one
broadcast."""

from __future__ import annotations

import torch

from convex_optimization_tpu_torch.parallel.collectives import broadcast0
from convex_optimization_tpu_torch.solvers.common import (
    SolverConfig,
    SolveState,
    record_check,
)
from convex_optimization_tpu_torch.solvers.fista import continue_loop


def check_loop(state: SolveState, cfg: SolverConfig, step, check,
               refresh=None) -> SolveState:
    """The check loop of every sharded solver: a check, then ``gap_every``
    steps, the exact residual ``refresh`` (the row and grid BCD) and a
    check, until ``continue_loop`` stops."""
    state = check(state)
    while continue_loop(state, cfg):
        for _ in range(cfg.gap_every):
            state = step(state)
        if refresh is not None:
            state = state._replace(r=refresh(state.x))
        state = check(state)
    return state


def finish_check(s: SolveState, info, nnz: torch.Tensor,
                 r_sq: torch.Tensor, z: torch.Tensor, pen, g,
                 col_norms: torch.Tensor | None) -> SolveState:
    """Every sharded check's end: the numbers of ``g``'s rank 0 (gap,
    primal, dual, rel_gap, nnz, alpha, ||r||) in one broadcast and one
    host sync, so that every rank makes the same stop decision and, with
    ``col_norms``, screens its columns (witness ``z``) against the same
    gap-safe sphere, even where the ranks' residuals are a rounding
    apart; then record_check."""
    bc = broadcast0(torch.stack([info.gap, info.primal, info.dual,
                                 info.rel_gap, nnz, info.alpha,
                                 torch.sqrt(r_sq)]), g)
    keep = s.keep_mask
    if col_norms is not None:
        keep = keep & pen.screen_keep(z, bc[5], bc[0], col_norms,
                                      r_norm=bc[6], primal=bc[1])
    vals = bc.tolist()
    host = dict(zip(("gap", "primal", "dual", "rel_gap"), vals[:4]))
    return record_check(s, host, s.x, int(vals[4]), keep)
