"""Batched-lambda path: every path point iterates at once against one read
of A per sweep.

Counterpart of ``convex_optimization_tpu/solvers/batched_path.py``.  The
sequential path (``solvers/lambda_path.py``) reads A once per sweep per
point; this one runs cyclic Gauss-Seidel block prox on an (L, n) batch of
iterates, each row with its own threshold, so the whole grid costs
max_l sweeps(lam_l) reads of A instead of their sum.  Points start cold;
at every check each point adopts its larger-lambda neighbour's iterate
when that is primal-better at its own lambda (the cascade warm start).
Certification: per-point f32 duality gaps with best-iterate tracking and
stall detection, as in lambda_path; then, where the JAX package stops on
the f32 readings alone, every point whose best reading is at or under tol
is read again in f64 (A in chunks, no whole f64 copy) before it is called
converged.  The f32 solve floors at a relative gap of a few 1e-6 (the
polish module's note), and its monitor misreads a gap near that floor: a
128 x 512 group instance at tol 1e-6 reads 0 where the f64 gap is 1.3e-6.
A point whose claim fails in f64 is finished by the f64 support polish
(``solvers/polish.py``) and read in f64 again; the gap returned is that
reading, and its x the polished one rounded to f32.  Where every claim
holds, the path is the JAX package's, with f64 gaps returned.  CV's fold
paths (``certify=False``) keep the JAX rule: only their x reach the
held-out error, and their gaps are not returned.

The JAX package runs the loop as one jitted while_loop; here it is a host
loop, as in ``solvers/bcd.py``: ``gap_every`` K5 sweeps, then the check on
device tensors (a K6 refresh, the row mask, a K7 witness, the gap over
(L,), best-iterate tracking and the cascade), then ONE host sync reading
(L,) best_rel and since_best for the exit test.  The stall, best-iterate,
cascade and chunking rules are unchanged.

With ``mesh`` (a ``parallel.mesh.ColumnGroup``) the grid runs
column-sharded, as the JAX package's ``_setup_sharded`` (its
``batched_path.py:289-450``): each rank sweeps its own slab of blocks
with K5 for every point against the replicated residual rows R, then ONE
all-reduce carries the packed payload [R_v - R (L m), sum X dX, sum dX dX,
sum base_diff (L each)] and every point takes the exact line search on
the summed direction, floored at 1/P, as the sharded BCD does.  The
check is K6 on the slab with b = 0, a psum, b subtracted once; K7 on the
slab; the penalty parts and ||X||^2 by psum, the dual norm by pmax.  The
exit test reads rank 0's numbers.  The f64 confirmation reads the slab
in f64 chunks and sums the partials the same way; a claim that fails
there is polished on the full problem by rank 0 and broadcast.

Not ported: the TPU's per-execution sweep budget (``EXEC_SWEEP_BUDGET``),
which existed only because long executions killed the TPU worker.  The
JAX gate's HBM check for a second copy of A does not carry over either:
here A is a view of A_t, so no second copy exists.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, NamedTuple

import torch

from convex_optimization_tpu_torch.core.objective import (
    gap_from_parts,
    lambda_max_t,
)
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    block_steps,
    pick_block_size_t,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    MAX_BATCH,
    ax_minus_b_batch_t,
    batch_sweep_t,
    eligible_batch,
    neg_at_r_batch_t,
    rows_of,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.parallel.collectives import (
    all_gather,
    broadcast0,
    pmax,
    psum,
)
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.lambda_path import (
    PathResult,
    lambda_path,
    path_grid,
)
from convex_optimization_tpu_torch.solvers.polish import polish_support


class _BatchState(NamedTuple):
    X: torch.Tensor            # (n_blocks, L, B) iterates
    R: torch.Tensor            # (L, m) residuals
    X_best: torch.Tensor       # (n_blocks, L, B) best-certified iterates
    R_best: torch.Tensor       # (L, m) exact residual at X_best (chunk
                               # warm starts reuse it)
    best_gap: torch.Tensor     # (L,)
    best_rel: torch.Tensor     # (L,)
    best_primal: torch.Tensor  # (L,)
    iters_done: torch.Tensor   # (L,) sweep count when each point was best
    since_best: torch.Tensor   # (L,) checks without a new best
    k: int                     # sweeps run
    checks: tuple = ()         # per check, the (L,) primal and rel_gap
                               # readings (host lists)


def _penalty_parts(kind: str, gsize: int, weights, X: torch.Tensor,
                   Z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lambda base penalty value and base dual norm (lam1 factored
    out): value_l = lam1_l * base_val_l, dual_norm_l = base_dual_l /
    lam1_l.  X, Z are (n_blocks, L, B); weights (n_blocks, 1, B/gsize)."""
    if kind == "l1":
        return X.abs().sum(dim=(0, 2)), Z.abs().amax(dim=(0, 2))
    if kind == "nonneg_l1":
        return (X.sum(dim=(0, 2)),                       # X >= 0 by prox
                torch.clamp(Z.amax(dim=(0, 2)), min=0.0))
    if kind == "group_l2":
        nb, L, B = X.shape
        gpb = B // gsize
        gn_x = torch.linalg.vector_norm(X.reshape(nb, L, gpb, gsize), dim=3)
        gn_z = torch.linalg.vector_norm(Z.reshape(nb, L, gpb, gsize), dim=3)
        return ((weights * gn_x).sum(dim=(0, 2)),
                (gn_z / weights).amax(dim=(0, 2)))
    raise ValueError(f"unknown penalty kind {kind!r}")


def _base_val_diff(kind: str, gsize: int, weights, X: torch.Tensor,
                   Xn: torch.Tensor) -> torch.Tensor:
    """Per-lambda base-penalty difference sum(base(Xn) - base(X)), the
    differences taken element by element before the sum (the JAX
    package's ``batched_path.py:272-286``): an f32 difference of two large
    sums cancels and deadlocks the sharded line search."""
    if kind == "l1":
        return (Xn.abs() - X.abs()).sum(dim=(0, 2))
    if kind == "nonneg_l1":
        return (Xn - X).sum(dim=(0, 2))                  # X, Xn >= 0
    nb, L, B = X.shape
    gpb = B // gsize
    gn_n = torch.linalg.vector_norm(Xn.reshape(nb, L, gpb, gsize), dim=3)
    gn_o = torch.linalg.vector_norm(X.reshape(nb, L, gpb, gsize), dim=3)
    return (weights * (gn_n - gn_o)).sum(dim=(0, 2))


def _init_batch_state(nb: int, B: int, m: int, L: int, b: torch.Tensor,
                      x0: torch.Tensor | None, r0: torch.Tensor | None,
                      dtype: torch.dtype,
                      rm: torch.Tensor | None = None) -> _BatchState:
    """Cold (zeros / -b) or warm (x0 (nb, B) / r0 (m,) broadcast over L)
    start.  With a row mask the cold residual is the masked -b (residual
    rows stay rm * (A x - b) throughout); a warm r0 is already masked (it
    comes from a masked run's R_best)."""
    dev = b.device
    if x0 is None:
        X0 = torch.zeros((nb, L, B), dtype=dtype, device=dev)
        b_eff = b if rm is None else rm * b
        R0 = (-b_eff).to(dtype)[None, :].expand(L, m).contiguous()
    else:
        X0 = x0.to(dtype)[:, None, :].expand(nb, L, B).contiguous()
        R0 = r0.to(dtype)[None, :].expand(L, m).contiguous()
    inf = torch.full((L,), float("inf"), dtype=dtype, device=dev)
    zeros = torch.zeros((L,), dtype=torch.int32, device=dev)
    return _BatchState(X=X0, R=R0, X_best=X0, R_best=R0, best_gap=inf,
                       best_rel=inf, best_primal=inf, iters_done=zeros,
                       since_best=zeros, k=0)


def _run_batched_loop(state: _BatchState, lam1s: torch.Tensor,
                      cfg: SolverConfig, sweep_once: Callable,
                      gap_check: Callable,
                      agree: Callable | None = None) -> _BatchState:
    """gap_every sweeps -> certify -> best-iterate tracking -> cascade warm
    start, until every point is converged or stalled, or max_iters.
    sweep_once(X, R) -> (X, R); gap_check(X, R) -> (R_exact, GapInfo over
    (L,), rho_aug, base_val).  ``agree`` maps the check's host-sync
    tensor to rank 0's (sharded: every rank leaves at the same check)."""
    L = lam1s.shape[0]
    not_first = torch.arange(L, device=lam1s.device) > 0
    while state.k < cfg.max_iters:
        X, R = state.X, state.R
        for _ in range(cfg.gap_every):
            X, R = sweep_once(X, R)
        R, info, rho_aug, base_val = gap_check(X, R)
        k = state.k + cfg.gap_every
        improved = info.rel_gap < state.best_rel
        X_best = torch.where(improved[None, :, None], X, state.X_best)
        R_best = torch.where(improved[:, None], R, state.R_best)
        best_rel = torch.where(improved, info.rel_gap, state.best_rel)
        best_gap = torch.where(improved, info.gap, state.best_gap)
        best_primal = torch.where(improved, info.primal, state.best_primal)
        iters_done = state.iters_done.masked_fill(improved, k)
        since_best = (state.since_best + 1).masked_fill(improved, 0)

        # cascade warm start: point l adopts point l-1's CURRENT iterate
        # when that iterate is primal-better at lam_l, evaluated from the
        # parts already reduced: P_l(x_{l-1}) = 0.5 rho_aug_{l-1}
        # + lam1_l base_val_{l-1}.  Lambdas descend, so the shift is
        # l-1 -> l; GS prox descent is monotone from any start.
        prev_aug = torch.cat([rho_aug[:1], rho_aug[:-1]])
        prev_val = torch.cat([base_val[:1], base_val[:-1]])
        primal_of_prev = 0.5 * prev_aug + lam1s * prev_val
        adopt = ((primal_of_prev < info.primal) & not_first
                 & (state.best_rel > cfg.tol))
        X = torch.where(adopt[None, :, None],
                        torch.cat([X[:, :1], X[:, :-1]], dim=1), X)
        R = torch.where(adopt[:, None], torch.cat([R[:1], R[:-1]]), R)

        # the check's one host sync
        host = torch.stack([best_rel.double(), since_best.double(),
                            info.primal.double(), info.rel_gap.double()])
        if agree is not None:
            host = agree(host)
        rel, since, primal, rel_now = host.tolist()
        state = _BatchState(X=X, R=R, X_best=X_best, R_best=R_best,
                            best_gap=best_gap, best_rel=best_rel,
                            best_primal=best_primal, iters_done=iters_done,
                            since_best=since_best, k=k,
                            checks=state.checks + ((primal, rel_now),))
        converged = [r <= cfg.tol for r in rel]
        stalled = [cfg.stall_checks > 0 and s >= cfg.stall_checks
                   for s in since]
        if all(c or s for c, s in zip(converged, stalled)):
            break
    return state


def _confirm(state: _BatchState, lam1s: torch.Tensor, tol: float,
             exact_gap: Callable, polish: Callable) -> _BatchState:
    """Read in f64 every point whose best f32 reading is at or under tol;
    polish each one that fails there and read it in f64 again.  The f64
    readings become the points' gaps (module docstring)."""
    claim = state.best_rel <= tol
    if not bool(claim.any()):
        return state
    rel, gap, R = exact_gap(state.X_best, claim)
    failed = claim & (rel > tol)
    X_best = state.X_best
    if bool(failed.any()):
        nb, _, B = X_best.shape
        X_pol = X_best.clone()
        for l in failed.nonzero().squeeze(1).tolist():
            x = polish(float(lam1s[l]), X_best[:, l].reshape(nb * B))
            X_pol[:, l] = x.reshape(nb, B)
        rel2, gap2, R2 = exact_gap(X_pol, failed)
        keep = failed & (rel2 < rel)
        X_best = torch.where(keep[None, :, None], X_pol, X_best)
        rel = torch.where(keep, rel2, rel)
        gap = torch.where(keep, gap2, gap)
        R = torch.where(keep[:, None], R2, R)
    dt = state.best_rel.dtype
    return state._replace(
        X_best=X_best,
        R_best=torch.where(claim[:, None], R.to(dt), state.R_best),
        best_rel=torch.where(claim, rel.to(dt), state.best_rel),
        best_gap=torch.where(claim, gap.to(dt), state.best_gap))


def _solve_batched(A_t: torch.Tensor, b: torch.Tensor, lam1s: torch.Tensor,
                   lam2: float, steps: torch.Tensor, penalty, weights,
                   state0: _BatchState, rm: torch.Tensor | None,
                   gsize: int, cfg: SolverConfig,
                   polish: Callable | None, g=None) -> _BatchState:
    """One chunk of the grid.  rm (m,) solves the row-masked problem
    (rm * A, rm * b) on the same A_t: the mask gates K5's residual updates
    and the refresh, so every gap quantity is the masked problem's.
    polish(lam, x) -> x is the f64 support polish of that problem at lam,
    rounded to A_t's dtype; None skips the f64 confirmation.

    With ``g`` (a ColumnGroup) A_t, X, steps, penalty and weights are this
    rank's slab of them and x in ``polish`` its slice; R and b are
    replicated (module docstring)."""
    kind = penalty.kind
    m = b.shape[0]
    if g is None:
        def total(t):
            return t

        def top(t):
            return t
    else:
        def total(t):
            return psum(t, g)

        def top(t):
            return pmax(t, g)

    def sweep_once(X, R):
        Xn, Rv = batch_sweep_t(A_t, X, R, steps, lam1s, lam2, penalty,
                               row_mask=rm)
        if g is None:
            return Xn, Rv
        # Jacobi across ranks: one all-reduce of the packed payload, then
        # the exact line search of each point on the summed direction,
        # floored at 1/P (always a descent), as the sharded BCD's
        L = X.shape[1]
        dX = Xn - X
        tot = psum(torch.cat([
            (Rv - R).reshape(-1), (X * dX).sum(dim=(0, 2)),
            (dX * dX).sum(dim=(0, 2)),
            _base_val_diff(kind, gsize, weights, X, Xn)]), g)
        dR = tot[:L * m].view(L, m)
        sxd, sdd, bvd = tot[L * m:].view(3, L)
        lin = (R * dR).sum(dim=1) + lam2 * sxd
        den = (dR * dR).sum(dim=1) + lam2 * sdd
        gamma = torch.clamp(-(lin + lam1s * bvd) / torch.clamp(den, min=1e-30),
                            0.0, 1.0)
        gamma = torch.clamp(gamma, min=1.0 / g.size)
        return X + gamma[None, :, None] * dX, R + gamma[:, None] * dR

    def gap_check(X, R):
        # the exact refresh pins the incremental residual's drift (on a
        # slab: K6 with b = 0, the partials summed, b subtracted once),
        # then one batched witness pass; gap_from_parts broadcasts over (L,)
        if g is None:
            R = ax_minus_b_batch_t(A_t, X, b)
        else:
            R = psum(ax_minus_b_batch_t(A_t, X, torch.zeros_like(b)), g) \
                - b[None, :]
        if rm is not None:
            R = rm[None, :] * R
        Z = neg_at_r_batch_t(A_t, R, X, lam2)
        base_val, base_dual = _penalty_parts(kind, gsize, weights, X, Z)
        L = X.shape[1]
        base_val, x_sq = total(torch.cat([
            base_val, (X * X).sum(dim=(0, 2))])).view(2, L)
        base_dual = top(base_dual)
        rho_aug = (R * R).sum(dim=1) + lam2 * x_sq
        info = gap_from_parts(
            rho_dot_b=-torch.mv(R, b),
            rho_aug_sq=rho_aug,
            g_value=lam1s * base_val,
            dual_norm_value=base_dual / torch.clamp(lam1s, min=1e-30),
        )
        return R, info, rho_aug, base_val

    def exact_gap(X, sel):
        # the check's gap in f64 for the points in sel, with A_t read in
        # chunks of ~256 MB of f64 (on a slab: its partials summed, b
        # subtracted once); returns (rel, gap) over (L,) and the
        # residuals (L, m), zero outside sel
        nb, L, B = X.shape
        f64 = torch.float64
        idx = sel.nonzero().squeeze(1)
        X64 = X[:, idx].to(f64)
        b64 = b.to(f64)
        step = max(1, (32 << 20) // (B * m))
        R64 = (-b64[None, :].repeat(idx.shape[0], 1) if g is None
               else torch.zeros((idx.shape[0], m), dtype=f64,
                                device=X.device))
        for k0 in range(0, nb, step):
            R64 += torch.einsum("kbm,klb->lm", A_t[k0:k0 + step].to(f64),
                                X64[k0:k0 + step])
        if g is not None:
            R64 = psum(R64, g) - b64[None, :]
        if rm is not None:
            R64 = rm.to(f64)[None, :] * R64
        Z64 = torch.empty_like(X64)
        for k0 in range(0, nb, step):
            Z64[k0:k0 + step] = -torch.einsum(
                "kbm,lm->klb", A_t[k0:k0 + step].to(f64), R64)
        Z64 -= lam2 * X64
        lam64 = lam1s[idx].to(f64)
        w64 = None if weights is None else weights.to(f64)
        base_val, base_dual = _penalty_parts(kind, gsize, w64, X64, Z64)
        nsel = idx.shape[0]
        base_val, x_sq = total(torch.cat([
            base_val, (X64 * X64).sum(dim=(0, 2))])).view(2, nsel)
        info = gap_from_parts(
            rho_dot_b=-torch.mv(R64, b64),
            rho_aug_sq=(R64 * R64).sum(dim=1) + lam2 * x_sq,
            g_value=lam64 * base_val,
            dual_norm_value=top(base_dual) / torch.clamp(lam64, min=1e-30),
        )
        rel = torch.zeros((L,), dtype=f64, device=X.device)
        gap = torch.zeros((L,), dtype=f64, device=X.device)
        R = torch.zeros((L, m), dtype=f64, device=X.device)
        return (rel.index_put((idx,), info.rel_gap),
                gap.index_put((idx,), info.gap), R.index_put((idx,), R64))

    state = _run_batched_loop(
        state0, lam1s, cfg, sweep_once, gap_check,
        None if g is None else (lambda t: broadcast0(t, g)))
    if polish is None:
        return state
    return _confirm(state, lam1s, cfg.tol, exact_gap, polish)


def _batch_gate_reason(problem: Problem, picked: tuple[int, int],
                       chunk: int, gsize: int, g=None) -> str | None:
    """None when the batched kernels can run; else a readable reason.
    ``gsize``: the group width of a group_l2 problem, 0 otherwise (K5's
    group prox needs more shared memory).  With ``g`` (a ColumnGroup) the
    blocks must divide over its ranks and each rank's slab must fit, on
    the rank's device."""
    if picked[1] != 0:
        return (f"no pad-free block size for (m={problem.m}, "
                f"n={problem.n})")
    P = 1 if g is None else g.size
    n_blocks = problem.n // picked[0]
    if n_blocks % P:
        return f"n_blocks={n_blocks} does not divide over {P} shards"
    n_name = "n" if g is None else "n_local"
    if not eligible_batch(problem.m, problem.n // P, picked[0], chunk,
                          dtype=problem.dtype,
                          device=problem.device if g is None else g.device,
                          gsize=gsize):
        return (f"eligible_batch failed for (m={problem.m}, "
                f"{n_name}={problem.n // P}, B={picked[0]}, L={chunk}, "
                f"dtype={problem.dtype})")
    return None


def _shard_block(n: int, B: int, multiple: int,
                 P: int) -> tuple[int, int] | None:
    """(width, 0): the widest pad-free block width <= B, on K5's step
    (multiples of lcm(8, multiple)), whose n / width blocks divide over P
    ranks; None where none does.  Config 2 (n = 50 000) picks B = 80 on
    one device, 625 blocks, which two ranks cannot share; B = 40 gives
    1250."""
    step = 8 * multiple // math.gcd(8, multiple)
    for b in range(B - B % step, step - 1, -step):
        if n % b == 0 and (n // b) % P == 0:
            return b, 0
    return None


def chunk_size(L: int) -> int:
    """Points per batched run: grids past MAX_BATCH run in consecutive
    equal chunks, each warm-started from the previous chunk's deepest
    solution."""
    return -(-L // -(-L // MAX_BATCH))


class PreparedBatch(NamedTuple):
    """One-time batched-solver set-up (block choice, K4), reusable across
    grids and row masks: K-fold CV's folds and refit share one."""
    solve_chunk: Callable | None  # (lam_c, x_warm, r_warm, rm, certify)
                                  # -> state
    A_t: torch.Tensor | None      # the (n_blocks, B, m) view of A (with
                                  # a mesh: this rank's slab of it)
    reason: str | None            # not None => gate failed
    slab: Problem | None = None   # with a mesh: this rank's slab problem


def prepare_batched_solver(problem: Problem, cfg: SolverConfig, *,
                           chunk: int = MAX_BATCH,
                           mesh=None) -> PreparedBatch:
    """Gate and set-up for the batched path.  When the gate fails, returns
    the reason with solve_chunk None (callers fall back loudly).  With
    ``mesh`` (a ColumnGroup) B is picked on the full n, as the JAX package
    does, and where its blocks do not divide over the ranks the widest
    narrower pad-free width whose blocks do (``_shard_block``; the JAX
    package falls back instead); each rank sets up its slab on the
    group's device (K4 on it); the state's X and the x of
    ``solve_chunk``'s warm start are the slab's rows."""
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    picked = pick_block_size_t(problem.n, 128, multiple)
    if mesh is not None and picked[1] == 0:
        picked = _shard_block(problem.n, picked[0], multiple,
                              mesh.size) or picked
    gsize = multiple if problem.penalty.kind == "group_l2" else 0
    reason = _batch_gate_reason(problem, picked, chunk, gsize, mesh)
    if reason is not None:
        return PreparedBatch(None, None, reason)

    B = picked[0]
    slab = None
    if mesh is None:
        A_t, pen, b = problem.with_block(B).A_t, problem.penalty, problem.b
    else:
        from convex_optimization_tpu_torch.parallel.sharded import (
            shard_columns,
        )

        slab = shard_columns(problem, mesh, B)
        A_t, pen, b = slab.A_t, slab.penalty, slab.b
    n_blocks = A_t.shape[0]
    # full-data block Lipschitz: a row mask only removes rows, so it
    # bounds every masked block's too (sound steps, no per-fold K4)
    steps = block_steps(block_power_t(A_t), problem.lam2, cfg.step_scale)
    weights = None
    if pen.kind == "group_l2":
        weights = pen._gweights(problem.dtype, A_t.device).reshape(
            n_blocks, 1, B // multiple)

    def solve_chunk(lam_c, x_warm, r_warm, rm=None, certify=True):
        state = _init_batch_state(n_blocks, B, problem.m, lam_c.shape[0],
                                  b, x_warm, r_warm, problem.dtype, rm)

        def polish(lam, x):
            p = problem
            if rm is not None:
                # only for a claim the f32 floor failed: a masked copy
                rmp = rm.to(problem.device)
                p = dataclasses.replace(problem, A_t=problem.A_t * rmp,
                                        b=problem.b * rmp)
            if mesh is None:
                pr = polish_support(p.with_lam1(lam), x, tol=cfg.tol)
                return torch.as_tensor(pr.x, dtype=problem.dtype,
                                       device=problem.device)
            # rank 0 polishes the whole x on the whole problem (every rank
            # holds it) and sends the result to the others
            x_full = all_gather(x, mesh)
            out = torch.zeros_like(x_full)
            if mesh.rank == 0:
                pr = polish_support(p.with_lam1(lam), x_full, tol=cfg.tol)
                out = torch.as_tensor(pr.x, dtype=problem.dtype,
                                      device=out.device)
            n_loc = x.shape[0]
            return broadcast0(out, mesh)[mesh.rank * n_loc:
                                         (mesh.rank + 1) * n_loc]

        return _solve_batched(A_t, b, lam_c.contiguous(), problem.lam2,
                              steps, pen, weights, state, rm, multiple, cfg,
                              polish if certify else None, mesh)

    return PreparedBatch(solve_chunk, A_t, None, slab)


def _gather_rows(X: torch.Tensor, g) -> torch.Tensor:
    """The (L, n) rows of X (n_blocks, L, B), with a mesh gathered from
    every rank's slab."""
    rows = rows_of(X)
    if g is None:
        return rows
    L, n_loc = rows.shape
    return all_gather(rows.reshape(-1), g).view(g.size, L, n_loc) \
        .transpose(0, 1).reshape(L, g.size * n_loc)


def _histories(checks: tuple, tol: float) -> list:
    """Each point's check readings (primal, rel_gap), up to the first
    check at which its f32 rel_gap reads tol (where a point solved alone
    would stop)."""
    import numpy as np

    if not checks:
        return []
    primal = np.asarray([c[0] for c in checks], dtype=np.float64)
    rel = np.asarray([c[1] for c in checks], dtype=np.float64)
    out = []
    for l in range(primal.shape[1]):
        hit = np.nonzero(rel[:, l] <= tol)[0]
        end = hit[0] + 1 if hit.size else rel.shape[0]
        out.append({"primal": primal[:end, l], "rel_gap": rel[:end, l]})
    return out


def batched_lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: torch.Tensor | None = None,
    row_mask: torch.Tensor | None = None,
    prepared: PreparedBatch | None = None,
    certify: bool = True,
    mesh=None,
) -> PathResult:
    """Solve the whole lambda grid at once; see the module docstring.

    Falls back to the sequential ``bcd_pallas`` path when the gate fails
    (not f32, no pad-free block size, or a K5 tile past shared memory;
    with a mesh, blocks that do not divide over its ranks), with a
    warning; ``PathResult.method_used`` records the solver that ran.
    With ``row_mask`` ((m,), 0/1) the path solves the row-masked problem
    (rm * A, rm * b) against the same A_t.  Pass ``prepared`` (from
    :func:`prepare_batched_solver`) to share one set-up across calls,
    e.g. across CV folds.  ``certify=False`` skips the f64 confirmation
    of the converged points (module docstring).  With ``mesh`` (a
    ColumnGroup; every rank calls this with the same problem) the grid
    runs on the ranks' slabs (``method_used`` 'bcd_batch+sharded') and
    xs are gathered on the group's device."""
    dev = problem.device if mesh is None else mesh.device
    rm = None
    if row_mask is not None:
        rm = torch.as_tensor(row_mask, dtype=problem.dtype,
                             device=dev).reshape(problem.m)
    if lambdas is None and mesh is None:
        b_eff = problem.b if rm is None else problem.b * rm
        # (rm A)^T (rm b) = A^T (rm b) for a 0/1 mask: no masked copy
        lmax = float(lambda_max_t(problem.A_t, b_eff, problem.penalty))
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                            problem.device)
    L = path_len if lambdas is None else len(lambdas)
    chunk = chunk_size(L)

    prep = prepared
    if prep is None:
        prep = prepare_batched_solver(problem, cfg, chunk=min(L, chunk),
                                      mesh=mesh)
    if prep.reason is not None:
        warnings.warn(
            f"bcd_batch gate failed ({prep.reason}); falling back to the "
            f"sequential bcd_pallas path — PathResult.method_used records "
            f"the substitution", stacklevel=2)
        p_eff = problem
        if rm is not None:
            # only reached where the gate fails, so the copy is small
            rmp = rm.to(problem.device)
            p_eff = dataclasses.replace(problem, A_t=problem.A_t * rmp,
                                        b=problem.b * rmp)
        return lambda_path(p_eff, cfg, lambdas=lambdas, path_len=path_len,
                           lam_min_frac=lam_min_frac, method="bcd_pallas",
                           mesh=mesh)
    if lambdas is None:
        slab = prep.slab
        b_eff = slab.b if rm is None else slab.b * rm
        from convex_optimization_tpu_torch.parallel.sharded import (
            sharded_lambda_max,
        )

        lmax = sharded_lambda_max(slab, mesh, b_eff)
        lambdas = path_grid(lmax, path_len, lam_min_frac, problem.dtype,
                            dev)
    lambdas = torch.as_tensor(lambdas, dtype=problem.dtype, device=dev)

    xs_parts, gaps_parts, iters_parts, histories = [], [], [], []
    sweeps = 0
    x_warm = r_warm = None
    for c0 in range(0, L, chunk):
        lam_c = lambdas[c0:c0 + chunk]
        final = prep.solve_chunk(lam_c, x_warm, r_warm, rm, certify)
        Lc = lam_c.shape[0]
        xs_parts.append(_gather_rows(final.X_best, mesh))
        gaps_parts.append(final.best_rel)
        iters_parts.append(final.iters_done)
        histories += _histories(final.checks, cfg.tol)
        sweeps += final.k
        if c0 + chunk < L:
            # warm-start the next chunk at the deepest certified point;
            # R_best is its exact (and, with a mask, masked) residual
            x_warm = final.X_best[:, Lc - 1, :]
            r_warm = final.R_best[Lc - 1]

    gaps = torch.cat(gaps_parts)
    return PathResult(
        lambdas=lambdas, xs=torch.cat(xs_parts), gaps=gaps,
        iters=torch.cat(iters_parts),
        method_used="bcd_batch" if mesh is None else "bcd_batch+sharded",
        converged=gaps <= cfg.tol, sweeps=sweeps, histories=histories)
