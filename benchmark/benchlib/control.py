"""The control: the plain reference put in the program's place, computed
one precision below what the configuration states.

The configurations state a float32 solve (float32 products, TF32 off) and
a float64 certificate.  The control steps each down once:

  * the solve: plain FISTA whose products with A run in TF32 (A and the
    vector rounded to 10 mantissa bits, products summed in float32: what
    a TF32 tensor core does);
  * the checks a solve stops on: in TF32 where the program checks in
    float32; where the program confirms a converged point in float64 (the
    batched path), the control confirms it in float32;
  * the polish: plain FISTA in float32 on the solve's support, in place of
    the float64 polish;
  * the certificate: the duality gap in float32, in place of float64.

Its outputs have the program's form, so ``jobs/<kind>.judge`` reads them
as it reads the program's.  It must come out not correct: ``readings.py``
reads it on the card at the cells' sizes, and a test at a small size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchlib import reference


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -8192).view(torch.float32)


class Products:
    """A x and A^T r in one precision: "tf32" or "f32"."""

    def __init__(self, A_rows: torch.Tensor, precision: str):
        self.q = tf32 if precision == "tf32" else (lambda t: t)
        self.A_rows = self.q(A_rows) if precision == "tf32" else A_rows

    def ax(self, x: torch.Tensor) -> torch.Tensor:
        return self.A_rows.T @ self.q(x)

    def atr(self, r: torch.Tensor) -> torch.Tensor:
        return self.A_rows @ self.q(r)


def gap32(P: Products, b: torch.Tensor, lam: float,
          x: torch.Tensor) -> float:
    """The relative duality gap in float32 (its products in P's
    precision)."""
    r = P.ax(x) - b
    z = P.atr(r)
    rr, rb = torch.dot(r, r), torch.dot(r, b)
    primal = 0.5 * rr + lam * x.abs().sum()
    alpha = torch.clamp(-rb / rr, min=0.0)
    alpha = torch.minimum(alpha, lam / z.abs().max())
    dual = alpha * -rb - 0.5 * alpha * alpha * rr
    return float((primal - dual) / primal.abs())


def lipschitz(P: Products, n: int, iters: int = 48) -> float:
    v = torch.sin(torch.arange(1, n + 1, dtype=torch.float32,
                               device=P.A_rows.device))
    v /= torch.linalg.vector_norm(v)
    s = 1.0
    for _ in range(iters):
        w = P.atr(P.ax(v))
        s = float(torch.linalg.vector_norm(w))
        v = w / s
    return 1.02 * s


def fista(P: Products, check: Products, b: torch.Tensor, lam: float,
          solver: dict, tol: float, x0: torch.Tensor | None = None,
          L: float | None = None) -> tuple:
    """Plain FISTA with gradient restart, a check every ``gap_every``
    steps in ``check``'s precision, and the stall rule.  Returns (the
    best-checked x, its gap, steps)."""
    n = P.A_rows.shape[0]
    L = lipschitz(P, n) if L is None else L
    x = torch.zeros(n, device=b.device) if x0 is None else x0.clone()
    y, t = x.clone(), 1.0
    best, x_best, stall = math.inf, x.clone(), 0
    k = 0
    while k < solver["max_iters"]:
        g = P.atr(P.ax(y) - b)
        v = y - g / L
        x_new = torch.sign(v) * torch.clamp(v.abs() - lam / L, min=0.0)
        if float(torch.dot(y - x_new, x_new - x)) > 0:
            t = 1.0
            y = x_new.clone()
        else:
            t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
            y = x_new + ((t - 1.0) / t_new) * (x_new - x)
            t = t_new
        x = x_new
        k += 1
        if k % solver["gap_every"] == 0:
            gap = gap32(check, b, lam, x)
            if gap < best:
                best, x_best, stall = gap, x.clone(), 0
            else:
                stall += 1
            if best <= tol or (solver.get("stall_checks", 0)
                               and stall >= solver["stall_checks"]):
                break
    return x_best, best, k


def polish32(A_rows: torch.Tensor, b: torch.Tensor, lam: float,
             x: torch.Tensor, steps: int = 3000) -> torch.Tensor:
    """The solve's support refined in float32 by plain FISTA."""
    S = torch.nonzero(x).flatten()
    if S.numel() == 0:
        return x.clone()
    P = Products(A_rows[S].contiguous(), "f32")
    xs, _, _ = fista(P, P, b, lam, {"max_iters": steps, "gap_every": steps},
                     0.0, x0=x[S])
    out = torch.zeros_like(x)
    out[S] = xs
    return out


def cert(inst, config: dict, traffic: dict) -> dict:
    """A certified solve, one precision down; the output ``jobs/cert``'s
    judge reads."""
    tol = float(config["tol"])
    P = Products(inst.A_rows, "tf32")
    x, _, _ = fista(P, P, inst.b, inst.lam1, traffic["solver"], tol)
    xp = polish32(inst.A_rows, inst.b, inst.lam1, x)
    c = gap32(Products(inst.A_rows, "f32"), inst.b, inst.lam1, xp)
    return {"x32": x.cpu().numpy(), "x64": xp.cpu().numpy().astype(
        np.float64), "cert": c}


def path(inst, config: dict, traffic: dict) -> dict:
    """A warm-started lambda path, one precision down; the output
    ``jobs/path``'s judge reads."""
    tol = float(config["tol"])
    P = Products(inst.A_rows, "tf32")
    confirm = traffic["method"] == "bcd_batch"
    lam_max = float((P.atr(inst.b)).abs().max())
    lams = reference.lambda_grid(lam_max, int(config["path_len"]),
                                 float(config["lam_min_frac"]))
    L = lipschitz(P, inst.A_rows.shape[0])
    xs, gaps, x = [], [], None
    for lam in lams:
        x, gap, _ = fista(P, P, inst.b, float(lam), traffic["solver"], tol,
                          x0=x, L=L)
        if confirm and gap <= tol:
            gap = gap32(Products(inst.A_rows, "f32"), inst.b, float(lam), x)
        xs.append(x.cpu().numpy().astype(np.float64))
        gaps.append(gap)
    return {"xs": np.stack(xs), "gaps": np.array(gaps),
            "converged": np.array(gaps) <= tol,
            "method_used": traffic["method"]}
