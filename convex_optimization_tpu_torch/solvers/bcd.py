"""Block-coordinate descent: Gauss-Seidel sweeps with a certified
duality-gap check every ``gap_every`` sweeps.

Counterpart of ``convex_optimization_tpu/solvers/bcd.py`` (its ``A_t``
branch).  The JAX package runs the whole solve as one jitted while_loop;
here the loop is Python on the host and the device work is one sweep launch
per sweep plus, per check, a K2 residual refresh and a K3 witness.  The
host syncs once per check, to read the gap that decides whether to go on.

The sweep is K1 where its shared-memory tile fits and K9, which streams
the block, otherwise (``pick_sweep``): the JAX package's order too, from
the VMEM-resident kernel to the tiled one (its ``solvers/bcd.py:80-120``).
"""

from __future__ import annotations

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    H100_SMS,
    block_steps,
    sweep_plan,
    sweep_route,
    sweep_t,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu_torch.ops.bcd_sweep_tiled import (
    sweep_tiled_t,
    tiled_plan,
)
from convex_optimization_tpu_torch.ops.matvec import (
    _aligned,
    ax_minus_b_t,
    neg_at_r_t,
)
from convex_optimization_tpu_torch.solvers.common import (
    SolverConfig,
    SolveState,
)
from convex_optimization_tpu_torch.solvers.fista import (  # noqa: F401
    _check_and_record,
    continue_loop,
    init_state,
    screen_norms,
)


def pick_block_size(n: int, target: int = 256, *,
                    multiple_of: int = 1) -> int:
    """Largest divisor of n that is <= target and a multiple of
    ``multiple_of``; falls back to the smallest valid divisor."""
    best = None
    d = multiple_of
    while d <= n:
        if n % d == 0:
            if d <= target:
                best = d
            elif best is None:
                best = d
                break
            else:
                break
        d += multiple_of
    if best is None:
        raise ValueError(f"no block size for n={n}, multiple_of={multiple_of}")
    return best


def pick_sweep(device: torch.device, B: int, m: int):
    """``sweep_t`` (K1) where its tile fits in shared memory, else
    ``sweep_tiled_t`` (K9); a CPU problem routes as an H100 would (both
    plain versions are the same sweep)."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    return sweep_t if sweep_route(B, m, sms) == "k1" else sweep_tiled_t


def prepare_sweep(A_t: torch.Tensor) -> None:
    """On a card: build the kernels and size the routed sweep's launch, so
    neither lands inside a timed solve (raises when no sweep fits)."""
    if A_t.device.type != "cuda":
        return
    _build.load()
    nb, B, m = A_t.shape
    if pick_sweep(A_t.device, B, m) is sweep_t:
        sweep_plan(A_t.device, B, m)
    else:
        tiled_plan(A_t.device, B, m, _aligned(A_t))


def bcd(problem: Problem, block_L: torch.Tensor, state: SolveState,
        cfg: SolverConfig,
        col_norms: torch.Tensor | None = None) -> SolveState:
    """Sweep until rel. duality gap <= cfg.tol, max_iters sweeps, or
    ``stall_checks`` checks without a new best.  block_L holds per-block
    ||A_j||_2^2 (no lam2); B = n / len(block_L).  With
    ``cfg.screen_every > 0`` every check screens and the sweeps freeze the
    screened coordinates through their keep mask (``col_norms`` as in
    ``fista.fista``).

    cfg.use_pallas: sweeps, refresh and witness go through K1 or K9
    (``pick_sweep``), K2, K3 (kernels for CUDA tensors, their plain
    versions for CPU tensors); otherwise the plain reference sweep and
    matvecs."""
    n_blocks = block_L.shape[0]
    B = problem.n // n_blocks
    # lam1 as a Python float: read once here, not once per launch
    problem = problem.with_lam1(float(problem.penalty.lam1)).with_block(B)
    A_t, lam2 = problem.A_t, problem.lam2
    col_norms = screen_norms(problem, cfg, col_norms)

    if cfg.use_pallas:
        steps = block_steps(block_L, lam2, cfg.step_scale)
        sweep_fn = pick_sweep(problem.device, B, problem.m)

        def sweep(st: SolveState):
            return sweep_fn(A_t, st.x, st.r, steps, st.keep_mask,
                            problem.penalty, lam2)

        def refresh_and_check(s: SolveState) -> SolveState:
            # exact residual refresh once per check pins the drift of the
            # incrementally maintained r; K3 reuses the fresh r
            r = ax_minus_b_t(A_t, s.x, problem.b)
            z = neg_at_r_t(A_t, r, s.x, lam2)
            return _check_and_record(problem, s._replace(r=r), z=z,
                                     col_norms=col_norms)
    else:
        order = range(n_blocks)

        def sweep(st: SolveState):
            return bcd_sweep_ref(problem, st.x, st.r, block_L, order,
                                 step_scale=cfg.step_scale,
                                 keep_mask=st.keep_mask)

        def refresh_and_check(s: SolveState) -> SolveState:
            s = s._replace(r=problem.residual(s.x))
            return _check_and_record(problem, s, col_norms=col_norms)

    state = refresh_and_check(state)
    while continue_loop(state, cfg):
        for _ in range(cfg.gap_every):
            x, r = sweep(state)
            state = state._replace(x=x, r=r, k=state.k + 1)
        state = refresh_and_check(state)
    return state


__all__ = ["bcd", "pick_block_size", "pick_sweep", "prepare_sweep",
           "init_state", "screen_norms"]
