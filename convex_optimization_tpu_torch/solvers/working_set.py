"""Working-set solver: solve restricted subproblems and expand them by
full-width screens (``solve(method='fista_ws' | 'bcd_ws')``).

Counterpart of ``convex_optimization_tpu/solvers/working_set.py``, with
its round structure:

  0. a short full-width burn-in, in batches of ``init_iters`` until the
     screen keeps at most 0.6 n columns (or the gap reaches tol);
  1. a gap-safe screen at x -> the working set W (kept columns and the
     nonzeros of x), padded to a bucket of stable size;
  2. a solve on A[:, W], warm-started, to tol or a stall: FISTA, or
     Gauss-Seidel sweeps (``inner='bcd'``);
  3. a full-width re-screen at the expanded-back x, which gives the next
     round's W and the honest full-width gap.

The reported gap is always the full-width one, so a loose screen costs a
round, never correctness.  Group working sets are whole groups, and the
compacted penalty carries the kept groups' weights.

Every pass over A is a kernel on a CUDA problem (the plain versions on a
CPU one): the screen is K2 then K3 on the full ``A_t``; the burn-in is
FISTA (K2/K3) or, for ``inner='bcd'``, K1/K9 sweeps with the full width's
K4 constants; the compact slab is one ``index_select`` of
``problem.A_rows`` (column j of A is row j of A_t) and every compact
solve runs the same kernels on it, with K4 on the slab for the BCD.  The
residual from the screen is threaded into every warm start (``r0``), so
no start computes A x.  The TPU package's backend and HBM gates, and its
XLA fallback, have no counterpart: where the slab has no pad-free sweep
block, its FISTA still runs K2/K3 on the slab.  The column norms the
screen reads are set-up, once per route (``make_ws_route``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import GapInfo, duality_gap
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    neg_at_r_t,
    spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.screening import compact_problem
from convex_optimization_tpu_torch.utils.device import sync


def _bucket(k: int, n: int, bucket: int) -> int:
    return min(n, -(-max(k, 1) // bucket) * bucket)


def _gsize(problem: Problem) -> int:
    pen = problem.penalty
    return problem.n // pen.ngroups if pen.kind == "group_l2" else 1


def _sweep_block(n: int, gsize: int) -> int:
    """The widest pad-free sweep block (<= 128, whole groups) of an
    n-column operand, 0 if there is none (the JAX package's
    ``pick_padded_block_size_vpu(..., 128, multiple_of=gsize)`` with pad
    0)."""
    B, pad = pick_block_size_t(n, 128, gsize)
    return 0 if pad else B


def make_ws_route(problem: Problem, inner: str = "fista") -> dict:
    """The lam-independent set-up of the working-set solver, for reuse
    across calls on the same A (lambda paths pass it as ``route=``):
    L_total = ||A||^2 + lam2 by the K2/K3 power iteration, the augmented
    column norms the screen reads, and for ``inner='bcd'`` the full
    width's sweep block ``B`` and its per-block constants ``block_L``
    (K4; None where n has no pad-free block: the burn-in is FISTA)."""
    if inner not in ("fista", "bcd"):
        raise ValueError(f"unknown inner solver {inner!r}")
    route = {"L_total": float(spectral_norm_sq_t(problem.A_t))
             + problem.lam2,
             "col_norms": problem.col_norms(), "block_L": None,
             "B": _sweep_block(problem.n, _gsize(problem))
             if inner == "bcd" else 0}
    if route["B"]:
        A_t = problem.with_block(route["B"]).A_t
        bcd_mod.prepare_sweep(A_t)
        route["block_L"] = block_power_t(A_t)
    return route


def screen(problem: Problem, x: torch.Tensor, col_norms: torch.Tensor,
           gsize: int = 1) -> tuple[np.ndarray, GapInfo, torch.Tensor]:
    """Full-width gap-safe screen at x: (sorted indices of the kept
    columns, whole groups for gsize > 1; the gap at x; r = A x - b).  r
    is K2's, the witness K3's, on the full ``A_t``; a coordinate with
    x_j != 0 is always kept."""
    r = ax_minus_b_t(problem.A_t, x, problem.b)
    z = neg_at_r_t(problem.A_t, r, x, problem.lam2)
    info = duality_gap(problem, x, r, z=z)
    keep = problem.penalty.screen_keep(
        z, info.alpha, info.gap, col_norms,
        r_norm=torch.sqrt(torch.dot(r, r)), primal=info.primal) | (x != 0)
    idx = np.nonzero(keep.cpu().numpy())[0]
    if gsize > 1 and len(idx):
        g = np.unique(idx // gsize)
        idx = (g[:, None] * gsize + np.arange(gsize)).ravel()
    return idx, info, r


def pad_to(idx: np.ndarray, k_b: int, n: int, gsize: int) -> np.ndarray:
    """idx padded to k_b columns by the lowest unused columns (whole
    groups for gsize > 1), sorted."""
    if k_b <= len(idx):
        return idx
    if gsize > 1:
        kept_g = np.unique(idx // gsize)
        extra_g = np.setdiff1d(np.arange(n // gsize),
                               kept_g)[:(k_b - len(idx)) // gsize]
        extra = (extra_g[:, None] * gsize + np.arange(gsize)).ravel()
    else:
        extra = np.setdiff1d(np.arange(n), idx)[:k_b - len(idx)]
    return np.sort(np.concatenate([idx, extra]))


def solve_working_set(problem: Problem, cfg: SolverConfig, *,
                      x0: torch.Tensor | None = None,
                      init_iters: int = 100, bucket: int = 2048,
                      max_rounds: int = 8, inner: str = "fista",
                      route: dict | None = None
                      ) -> tuple[torch.Tensor, GapInfo, dict]:
    """Returns (x, the full-width GapInfo at x, meta) with meta's keys
    rounds, inner_iters (steps and sweeps of every phase), wall_s,
    setup_s, burn_s and ws_size (the last screen's working set).

    ``inner``: 'fista' (the compact solve reuses the full width's L_total,
    a sound bound) or 'bcd' (K1/K9 sweeps, K4 constants per slab; the
    burn-in sweeps too where the full width has a pad-free block).
    ``route``: a ``make_ws_route(problem, inner)`` dict from an earlier
    call on the same A (built here when None)."""
    if inner not in ("fista", "bcd"):
        raise ValueError(f"unknown inner solver {inner!r}")
    n, device = problem.n, problem.device
    gsize = _gsize(problem)
    # adaptive bucket: 2048 suits n = 100k, but would round a small
    # working set up to all of a small problem; multiples of 128 keep
    # every bucket sweep-block-eligible
    bucket = min(bucket, max(128, (n // 8) // 128 * 128))
    sync(device)
    t0 = time.perf_counter()
    if route is None:
        route = make_ws_route(problem, inner)
    L_total, col_norms = route["L_total"], route["col_norms"]

    cfg0 = dataclasses.replace(cfg, max_iters=init_iters,
                               gap_every=min(cfg.gap_every, init_iters),
                               stall_checks=0, screen_every=0)
    if inner == "bcd" and route["B"]:
        # the burn-in is this solver's full-width cost: one sweep reads A
        # once, a FISTA step twice
        p_full = problem.with_block(route["B"])
        cfg0b = dataclasses.replace(cfg0, use_pallas=True)

        def burn(st):
            return bcd_mod.bcd(p_full, route["block_L"], st, cfg0b)
    else:
        def burn(st):
            return fista_mod.fista(problem, L_total, st, cfg0)

    if x0 is None:
        x = torch.zeros((n,), dtype=problem.dtype, device=device)
        r_cur = -problem.b
    else:
        x = x0.to(device=device, dtype=problem.dtype)
        r_cur = ax_minus_b_t(problem.A_t, x, problem.b)
    sync(device)
    t_setup = time.perf_counter() - t0
    total_inner = 0
    for _ in range(10):
        s = burn(fista_mod.init_state(problem, x, r0=r_cur))
        x, r_cur = s.x, s.r
        total_inner += s.k
        idx, info, r_full = screen(problem, x, col_norms, gsize)
        if float(info.rel_gap) <= cfg.tol or len(idx) <= 0.6 * n:
            break
    t_burn = time.perf_counter() - t0 - t_setup

    # compact solves always stop on a stall: they reach the subproblem's
    # f32 floor, and the full-width re-screen follows anyway
    cfg_ws = dataclasses.replace(cfg, screen_every=0,
                                 stall_checks=cfg.stall_checks or 5)
    rounds = 0
    prev_gap = float("inf")
    for rounds in range(1, max_rounds + 1):
        g = float(info.rel_gap)
        if g <= cfg.tol or g > 0.9 * prev_gap:
            break      # converged, or stalled at the f32 floor
        prev_gap = g
        k_b = _bucket(len(idx), n, bucket)
        if gsize > 1:
            k_b = min(n, -(-k_b // gsize) * gsize)
        if k_b >= n:
            # the working set is everything: the plain full-width solve
            # (the final screen recomputes the honest gap and ws_size)
            s = fista_mod.fista(problem, L_total,
                                fista_mod.init_state(problem, x, r0=r_full),
                                cfg_ws)
            x = s.x_best
            total_inner += s.k
            idx, info, r_full = screen(problem, x, col_norms, gsize)
            break
        keep = np.zeros((n,), dtype=bool)
        keep[pad_to(idx, k_b, n, gsize)] = True
        B_ws = _sweep_block(k_b, gsize)
        p_ws, idx_t = compact_problem(problem, keep, B_ws)
        # x is 0 off W, so r_full is also the slab's residual at x[W]
        st0 = fista_mod.init_state(p_ws, x.index_select(0, idx_t),
                                   r0=r_full)
        if inner == "bcd" and B_ws:
            bcd_mod.prepare_sweep(p_ws.A_t)
            s_ws = bcd_mod.bcd(p_ws, block_power_t(p_ws.A_t), st0,
                               dataclasses.replace(cfg_ws, use_pallas=True))
        else:
            s_ws = fista_mod.fista(p_ws, L_total, st0, cfg_ws)
        total_inner += s_ws.k
        x = torch.zeros((n,), dtype=problem.dtype,
                        device=device).index_copy_(0, idx_t, s_ws.x_best)
        del p_ws, s_ws, st0
        idx, info, r_full = screen(problem, x, col_norms, gsize)

    sync(device)
    return x, info, {"rounds": rounds, "inner_iters": total_inner,
                     "wall_s": time.perf_counter() - t0, "setup_s": t_setup,
                     "burn_s": t_burn, "ws_size": int(len(idx))}


__all__ = ["make_ws_route", "pad_to", "screen", "solve_working_set"]
