"""The plain reference of the nonnegative elastic net: its duality gap, its
lambda_max and a plain solver, in float64, from the benchmark's own A and
b.

    min_x  0.5 ||A x - b||^2 + 0.5 lam2 ||x||^2 + lam1 sum(x)   s.t. x >= 0

It imports nothing of the program and takes nothing the program made.  The
gap is written from the augmented lasso A~ = [A; sqrt(lam2) I], b~ = [b; 0]
with the nonnegative l1 penalty: its residual is r~ = [r; sqrt(lam2) x]
(r = A x - b), so with

    z = -A~^T r~ = -A^T r - lam2 x
    P = 0.5 (||r||^2 + lam2 ||x||^2) + lam1 sum(x), +inf if any x < 0
    alpha = min(max(-(r . b) / (||r||^2 + lam2 ||x||^2), 0),
                lam1 / max(max(z), 0))
    D = alpha (-(r . b)) - 0.5 alpha^2 (||r||^2 + lam2 ||x||^2)
    rel_gap = (P - D) / |P|:

the dual point -alpha r~ is feasible (alpha z_j <= lam1 for every j: the
nonnegative penalty's dual norm is the largest z_j, not the largest |z_j|)
and alpha maximises D over the feasible range.  Every product is exact in
f64 over every column; A is read in ``reference.CHUNK`` rows of A_rows at a
time, as ``reference.py`` reads it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchlib.reference import at_r, residual


def _f64(x, device) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.float64)


def lambda_max_nonneg(A_rows: torch.Tensor, b: torch.Tensor) -> float:
    """max(A^T b)_+ in f64: the smallest lam1 at which x = 0 solves the
    nonnegative problem (lam2 does not move it)."""
    return max(float(at_r(A_rows, b.to(torch.float64)).max()), 0.0)


def rel_gap(A_rows: torch.Tensor, b: torch.Tensor, lam1: float,
            lam2: float, x) -> float:
    """The relative duality gap of the nonnegative elastic net at x, in
    f64 (+inf where x has a negative entry)."""
    x = _f64(x, A_rows.device)
    if bool((x < 0).any()):
        return math.inf
    r = residual(A_rows, b, x)
    z = -at_r(A_rows, r) - lam2 * x
    rho = float(r @ r) + lam2 * float(x @ x)
    rb = float(r @ b.to(torch.float64))
    primal = 0.5 * rho + lam1 * float(x.sum())
    zmax = max(float(z.max()), 0.0)
    alpha = min(max(-rb / max(rho, 1e-300), 0.0),
                lam1 / zmax if zmax > 0 else math.inf)
    dual = alpha * -rb - 0.5 * alpha * alpha * rho
    return (primal - dual) / max(abs(primal), np.finfo(np.float64).tiny)


def objective(A_rows: torch.Tensor, b: torch.Tensor, lam1: float,
              lam2: float, x) -> float:
    """P(x) in f64 (+inf where x has a negative entry)."""
    x = _f64(x, A_rows.device)
    if bool((x < 0).any()):
        return math.inf
    r = residual(A_rows, b, x)
    return (0.5 * (float(r @ r) + lam2 * float(x @ x))
            + lam1 * float(x.sum()))


def solve_cd(A_rows: torch.Tensor, b: torch.Tensor, lam1: float,
             lam2: float, tol: float = 1e-12,
             max_rounds: int = 200) -> np.ndarray:
    """Plain projected coordinate descent in f64, for small sizes: one
    sweep over every column, then sweeps over the nonzero ones until they
    settle, until ``rel_gap`` <= tol.  Coordinate j moves to
    max(0, x_j - (A_j . r + lam2 x_j + lam1) / (||A_j||^2 + lam2)),
    the exact minimiser along it."""
    A = A_rows.to(torch.float64).cpu().numpy()
    r = -b.to(torch.float64).cpu().numpy()
    n = A.shape[0]
    x = np.zeros(n)
    curv = np.einsum("ij,ij->i", A, A) + lam2

    def sweep(cols) -> float:
        moved = 0.0
        for j in cols:
            new = max(0.0, x[j] - (A[j] @ r + lam2 * x[j] + lam1) / curv[j])
            d = new - x[j]
            if d != 0.0:
                r[:] += d * A[j]
                x[j] = new
                moved = max(moved, abs(d))
        return moved

    for _ in range(max_rounds):
        sweep(range(n))
        active = np.flatnonzero(x)
        for _ in range(1000):
            if sweep(active) <= 1e-15 * max(1.0, np.abs(x).max()):
                break
        if rel_gap(A_rows, b, lam1, lam2, x) <= tol:
            break
    return x
