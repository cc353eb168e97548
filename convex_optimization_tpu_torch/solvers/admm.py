"""ADMM splitting solver with an exact x-update (``solve(method='admm')``).

Counterpart of ``convex_optimization_tpu/solvers/admm.py``.  The split

    min 0.5||Ax-b||^2 + (lam2/2)||x||^2 + g(z)  s.t. x = z

    x+ = (A^T A + (lam2+rho) I)^{-1} (A^T b + rho (z - u))
    z+ = prox_{g/rho}(x+ + u)
    u+ = u + x+ - z+

The x-update is exact through one eigendecomposition of the small-side
Gram matrix at set-up: with G = V diag(s) V^T, the inverse for any shift c
is V diag(1/(s+c)) V^T, so the residual balancing of rho needs no new
factorisation.  n > m uses the Woodbury identity on A A^T (m x m).

As in ``fista.py`` the loop runs on the host and syncs once per check;
rho and the balancing decision stay on the device (``torch.where``).  The
passes over A inside the loop are kernels: A q by K2 (b = 0), A^T w by K3
(x = 0, lam2 = 0, negated), and the check's residual and witness at z by
K2 and K3.  The Gram at set-up is one ``torch.matmul`` with TF32 off (the
JAX package forms it outside every Pallas kernel too).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import gap_from_parts
from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.ops.matvec import ax_minus_b_t, neg_at_r_t
from convex_optimization_tpu_torch.solvers.common import (
    History,
    SolverConfig,
    count_nnz,
)
from convex_optimization_tpu_torch.solvers.fista import continue_loop
from convex_optimization_tpu_torch.utils.device import sync as _sync


@dataclasses.dataclass(frozen=True)
class ADMMFactors:
    """Eigendecomposition of the small-side Gram, reused for every rho and
    every lam1 of a path."""

    V: torch.Tensor        # (k, k) eigenvectors, k = min(m, n)
    s: torch.Tensor        # (k,) eigenvalues of the Gram, clipped at 0
    Atb: torch.Tensor      # (n,) A^T b
    use_woodbury: bool     # True: k = m (n > m); False: k = n
    setup_s: dict = dataclasses.field(default_factory=dict)  # gram_s,
                           # eigh_s: the set-up's two parts (wall seconds)


class ADMMState(NamedTuple):
    """Device tensors, rho and the residual norms as 0-d device tensors,
    and the last check's host scalars (as ``common.SolveState``)."""

    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    rho: torch.Tensor
    k: int
    rel_gap: float
    gap: float
    primal: float
    r_prim: torch.Tensor     # ||x - z||
    r_dual: torch.Tensor     # rho ||z - z_prev||
    history: History
    best_rel_gap: float
    stall: int
    x_best: torch.Tensor
    best_gap: float
    best_primal: float


def _gram(problem: Problem) -> tuple[torch.Tensor, bool]:
    """(G, use_woodbury): A A^T (m x m) for n > m, else A^T A (n x n), one
    ``torch.matmul`` in the problem's dtype.  Raises when TF32 is on for a
    float32 product on the card (a TF32 Gram keeps about three digits and
    would change every x-update)."""
    if (problem.device.type == "cuda" and problem.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the ADMM Gram needs full float32: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    A_rows = problem.A_rows                       # A^T, (n, m)
    use_woodbury = problem.n > problem.m
    G = (torch.matmul(A_rows.T, A_rows) if use_woodbury
         else torch.matmul(A_rows, A_rows.T))
    return G, use_woodbury


def _atb(problem: Problem) -> torch.Tensor:
    """A^T b by K3: -(A^T (-b)) - 0 x."""
    zeros = torch.zeros((problem.n,), dtype=problem.dtype,
                        device=problem.device)
    return neg_at_r_t(problem.A_t, -problem.b, zeros, 0.0)


def _timed(fn, device):
    """(fn(), its wall seconds, the device synced at both ends)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def admm_setup(problem: Problem) -> ADMMFactors:
    """Set-up on the problem's device: the Gram, then its ``eigh`` in the
    problem's dtype."""
    (G, use_woodbury), gram_s = _timed(lambda: _gram(problem),
                                       problem.device)
    (s, V), eigh_s = _timed(lambda: torch.linalg.eigh(G), problem.device)
    del G
    return ADMMFactors(V=V, s=torch.clamp(s, min=0.0), Atb=_atb(problem),
                       use_woodbury=use_woodbury,
                       setup_s={"gram_s": gram_s, "eigh_s": eigh_s})


def admm_setup_host(problem: Problem) -> ADMMFactors:
    """Set-up with the eigendecomposition in float64 on the host: the Gram
    on the device in the problem's dtype, fetched, symmetrised and given
    to LAPACK; the factors go back to the device in the problem's dtype,
    and the loop is unchanged.  A float64 eigh is backward stable, so the
    remaining errors are the Gram's own rounding (a fixed perturbation)
    and applying V in the loop; the gap checks are computed from A
    itself either way."""
    (G, use_woodbury), gram_s = _timed(lambda: _gram(problem),
                                       problem.device)
    t0 = time.perf_counter()
    G64 = G.cpu().numpy().astype(np.float64)
    del G
    G64 = 0.5 * (G64 + G64.T)                # exact symmetry for LAPACK
    s64, V64 = np.linalg.eigh(G64)
    del G64
    s64 = np.maximum(s64, 0.0)
    dt, dev = problem.dtype, problem.device
    return ADMMFactors(V=torch.from_numpy(V64).to(device=dev, dtype=dt),
                       s=torch.from_numpy(s64).to(device=dev, dtype=dt),
                       Atb=_atb(problem), use_woodbury=use_woodbury,
                       setup_s={"gram_s": gram_s,
                                "eigh_s": time.perf_counter() - t0})


def factorize(problem: Problem, setup: str) -> ADMMFactors:
    """``admm_setup`` (setup='device') or ``admm_setup_host`` ('host')."""
    if setup == "device":
        return admm_setup(problem)
    if setup == "host":
        return admm_setup_host(problem)
    raise ValueError(f"admm_setup must be 'device' or 'host', got {setup!r}")


def _x_update(problem: Problem, fac: ADMMFactors, q: torch.Tensor,
              c) -> torch.Tensor:
    """Solve (A^T A + c I) x = q exactly in the cached eigenbasis.  The
    Woodbury branch's A q is K2 with b = 0 and its A^T w is K3 with x = 0
    and lam2 = 0, negated: K3's rounding bound was stated for the dual
    witness (``ops/matvec.witness_gamma``), and holds for this product as
    for any other r."""
    V, s = fac.V, fac.s
    if fac.use_woodbury:
        # (A^T A + cI)^{-1} q = (q - A^T (AA^T + cI)^{-1} A q) / c
        zeros_m = torch.zeros((problem.m,), dtype=q.dtype, device=q.device)
        zeros_n = torch.zeros_like(q)
        Aq = ax_minus_b_t(problem.A_t, q, zeros_m)
        w = torch.mv(V, torch.mv(V.T, Aq) / (s + c))
        return (q + neg_at_r_t(problem.A_t, w, zeros_n, 0.0)) / c
    return torch.mv(V, torch.mv(V.T, q) / (s + c))


def init_state(problem: Problem, x0: torch.Tensor | None,
               rho0=None) -> ADMMState:
    """Start at x0 (zeros when None) with u = 0 and rho0, by default
    max(lam1, 1e-6): the first prox threshold lam1 / rho is then ~1."""
    n, dtype, device = problem.n, problem.dtype, problem.device
    if rho0 is None:
        rho0 = max(float(problem.penalty.lam1), 1e-6)
    x = (torch.zeros((n,), dtype=dtype, device=device) if x0 is None
         else x0.to(device=device, dtype=dtype).clone())
    inf = torch.full((), math.inf, dtype=dtype, device=device)
    return ADMMState(
        x=x, z=x, u=torch.zeros((n,), dtype=dtype, device=device),
        rho=torch.as_tensor(rho0, dtype=dtype, device=device).clone(), k=0,
        rel_gap=math.inf, gap=math.inf, primal=math.inf, r_prim=inf,
        r_dual=inf, history=History(), best_rel_gap=math.inf, stall=0,
        x_best=x, best_gap=math.inf, best_primal=math.inf)


def _gap_check(problem: Problem, state: ADMMState) -> ADMMState:
    """Duality-gap certificate at the feasible iterate z (z is the sparse
    output; x is dense until convergence): r by K2, the witness by K3, one
    host sync."""
    z = state.z
    r = ax_minus_b_t(problem.A_t, z, problem.b)
    w = neg_at_r_t(problem.A_t, r, z, problem.lam2)
    info = gap_from_parts(
        rho_dot_b=-torch.dot(r, problem.b),
        rho_aug_sq=torch.dot(r, r) + problem.lam2 * torch.dot(z, z),
        g_value=problem.penalty.value(z),
        dual_norm_value=problem.penalty.dual_norm(w))
    gap, primal, dual, rel, nnz = torch.stack(
        [info.gap, info.primal, info.dual, info.rel_gap,
         count_nnz(z).to(info.gap.dtype)]).tolist()
    state.history.record(state.k, primal, dual, gap, rel, nnz)
    improved = rel < state.best_rel_gap
    return state._replace(
        rel_gap=rel, gap=gap, primal=primal,
        best_rel_gap=min(rel, state.best_rel_gap),
        stall=0 if improved else state.stall + 1,
        x_best=z if improved else state.x_best,
        best_gap=gap if improved else state.best_gap,
        best_primal=primal if improved else state.best_primal)


def admm_step(problem: Problem, fac: ADMMFactors,
              s: ADMMState) -> ADMMState:
    """One ADMM iteration with residual balancing: rho doubles when the
    primal residual exceeds twice the dual one, halves in the opposite
    case, and the scaled dual u is rescaled with it (the JAX package's
    deadband mu = 2)."""
    c = problem.lam2 + s.rho
    q = fac.Atb + s.rho * (s.z - s.u)
    x = _x_update(problem, fac, q, c)
    xu = x + s.u
    z = problem.penalty.prox(xu, 1.0 / s.rho)
    u = xu - z
    r_prim = torch.linalg.vector_norm(x - z)
    r_dual = s.rho * torch.linalg.vector_norm(z - s.z)
    one = torch.ones_like(s.rho)
    factor = torch.where(r_prim > 2.0 * r_dual, 2.0 * one,
                         torch.where(r_dual > 2.0 * r_prim, 0.5 * one, one))
    return s._replace(x=x, z=z, u=u / factor, rho=s.rho * factor,
                      k=s.k + 1, r_prim=r_prim, r_dual=r_dual)


def admm(problem: Problem, fac: ADMMFactors, state: ADMMState,
         cfg: SolverConfig) -> ADMMState:
    """Run ADMM until rel. duality gap <= cfg.tol, ``max_iters``
    iterations or ``stall_checks`` checks without a new best; a check
    every ``gap_every`` iterations.  Returns the state with x := z, the
    iterate the certificate refers to (x_best tracks the best z)."""
    # lam1 as a Python float: read once here, not once per step
    problem = problem.with_lam1(float(problem.penalty.lam1))
    state = _gap_check(problem, state)
    while continue_loop(state, cfg):
        for _ in range(cfg.gap_every):
            state = admm_step(problem, fac, state)
        state = _gap_check(problem, state)
    return state._replace(x=state.z)


__all__ = ["ADMMFactors", "ADMMState", "admm", "admm_setup",
           "admm_setup_host", "factorize", "init_state"]
