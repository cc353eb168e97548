"""The plain reference: the lasso's duality gap and its lambda grid, in
float64, from the benchmark's own A and b.

It imports nothing of the program and takes nothing the program made.  The
relative duality gap is the one the program certifies (and the JAX
package before it): with r = A x - b,

    P = 0.5 ||r||^2 + lam ||x||_1
    alpha = min(max(-(r . b) / ||r||^2, 0), lam / ||A^T r||_inf)
    D = alpha (-(r . b)) - 0.5 alpha^2 ||r||^2
    rel_gap = (P - D) / P,

every product exact in f64, over every column.  A is read in blocks of
rows of A_rows (columns of A), each cast to f64, so the reference needs
one block's f64 copy beside A.
"""

from __future__ import annotations

import numpy as np
import torch

#: rows of A_rows cast to f64 at a time (8192 x 10 000 x 8 B = 655 MB)
CHUNK = 8192


def _rows64(A_rows: torch.Tensor, c0: int) -> torch.Tensor:
    return A_rows[c0:c0 + CHUNK].to(torch.float64)


def at_r(A_rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A^T r in f64 (r f64)."""
    out = torch.empty((A_rows.shape[0],), dtype=torch.float64,
                      device=A_rows.device)
    for c0 in range(0, A_rows.shape[0], CHUNK):
        out[c0:c0 + CHUNK] = _rows64(A_rows, c0) @ r
    return out


def residual(A_rows: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """A x - b in f64; blocks where x is zero are skipped."""
    x = x.to(device=A_rows.device, dtype=torch.float64)
    r = -b.to(torch.float64)
    for c0 in range(0, A_rows.shape[0], CHUNK):
        xc = x[c0:c0 + CHUNK]
        nz = torch.nonzero(xc).flatten()
        if nz.numel():
            r += A_rows[c0:c0 + CHUNK][nz].to(torch.float64).T @ xc[nz]
    return r


def lambda_max(A_rows: torch.Tensor, b: torch.Tensor) -> float:
    """max_j |A_j . b| in f64: the smallest lam at which x = 0 solves the
    lasso."""
    return float(at_r(A_rows, b.to(torch.float64)).abs().max())


def lambda_grid(lam_max: float, path_len: int,
                lam_min_frac: float) -> np.ndarray:
    """The path's grid: geometric from 0.95 lam_max to lam_min_frac
    lam_max (just below lam_max, where the solution is exactly 0)."""
    return np.geomspace(0.95 * lam_max, lam_min_frac * lam_max, path_len)


def rel_gap(A_rows: torch.Tensor, b: torch.Tensor, lam: float,
            x) -> float:
    """The relative duality gap of the lasso at x, in f64."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).to(device=A_rows.device, dtype=torch.float64)
    b64 = b.to(torch.float64)
    r = residual(A_rows, b, x)
    z = at_r(A_rows, r)
    rr = float(r @ r)
    rb = float(r @ b64)
    primal = 0.5 * rr + lam * float(x.abs().sum())
    alpha = min(max(-rb / max(rr, 1e-300), 0.0),
                lam / max(float(z.abs().max()), 1e-300))
    dual = alpha * -rb - 0.5 * alpha * alpha * rr
    return (primal - dual) / max(abs(primal), np.finfo(np.float64).tiny)
