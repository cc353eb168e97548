"""A certified nonnegative elastic-net solve with gap-safe screening:
``jobs/cert.py``'s request (``solve`` in f32 from x0 = 0 under
``bench.solve``, then the f64 support polish under ``bench.polish``, the
same keys back) on config 3's problem: ``penalty`` nonneg_l1 and ``lam2``
from the configuration, the data of ``benchlib/data_en.py``.

Each request's outputs add the solve's final keep mask
(``Result.keep_mask``), so the judge can check that no column the screen
froze ends nonzero.  A program that returns no mask fails before the
window opens.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchlib import control as control_mod
from benchlib import data_en, reference_en, spec

_cert = spec.job_module("cert")

METRIC = _cert.METRIC


class Job(_cert.Job):
    def prepare(self, insts: list) -> None:
        lam2 = float(self.cell.config["lam2"])
        self.problems = []
        for inst in insts:
            en = data_en.nonneg(inst, self.cell.config)
            self.problems.append(self.cot.make_problem(
                en.A, en.b, en.lam1, lam2=lam2,
                penalty=self.cot.nonneg_l1(en.lam1)))

    def _solve(self, problem, **over):
        self.last = super()._solve(problem, **over)
        return self.last

    def warmup(self) -> None:
        super().warmup()
        if self.last.keep_mask is None:
            raise RuntimeError("the screened solve returned no keep mask")

    def request(self, clock, i: int) -> dict:
        out = super().request(clock, i)
        self.outputs[-1]["keep"] = self.last.keep_mask.cpu().numpy()
        return out

    def free(self) -> None:
        super().free()
        self.last = None


def judge(inst, config: dict, traffic: dict, out: dict) -> dict:
    """The numbers of one request, from the reference on config 3's data:

    gap         f64 relative gap at the polished x (the certificate's claim)
    cert_err    |the certificate - that gap| / tol
    solve_gap   f64 relative gap at the solve's f32 x
    neg         entries below 0 in either x
    screen_err  columns the final keep mask froze that are nonzero in the
                polished x (none where no mask: nothing was frozen)
    """
    en = data_en.nonneg(inst, config)
    tol, lam2 = float(config["tol"]), float(config["lam2"])
    gap = reference_en.rel_gap(en.A_rows, en.b, en.lam1, lam2, out["x64"])
    keep = out.get("keep")
    frozen_nz = (0 if keep is None
                 else int(np.count_nonzero(out["x64"][~keep])))
    return {"gap": gap,
            "cert_err": abs(out["cert"] - gap) / tol,
            "solve_gap": reference_en.rel_gap(en.A_rows, en.b, en.lam1,
                                              lam2, out["x32"]),
            "neg": int(np.count_nonzero(out["x64"] < 0)
                       + np.count_nonzero(out["x32"] < 0)),
            "screen_err": frozen_nz}


# ---- the control: the reference one precision down (benchlib/control.py)


def gap32(P, b: torch.Tensor, lam1: float, lam2: float,
          x: torch.Tensor) -> float:
    """The nonnegative elastic net's relative gap in float32 (products in
    P's precision); ``reference_en``'s formula."""
    if bool((x < 0).any()):
        return math.inf
    r = P.ax(x) - b
    z = -P.atr(r) - lam2 * x
    rho = torch.dot(r, r) + lam2 * torch.dot(x, x)
    rb = torch.dot(r, b)
    primal = 0.5 * rho + lam1 * x.sum()
    alpha = torch.clamp(-rb / rho, min=0.0)
    zmax = torch.clamp(z.max(), min=0.0)
    if float(zmax) > 0:
        alpha = torch.minimum(alpha, lam1 / zmax)
    dual = alpha * -rb - 0.5 * alpha * alpha * rho
    return float((primal - dual) / primal.abs())


def fista(P, b: torch.Tensor, lam1: float, lam2: float, solver: dict,
          tol: float, x0: torch.Tensor | None = None) -> tuple:
    """Projected FISTA (the nonnegative prox, lam2 in the gradient) with
    gradient restart, a check every ``gap_every`` steps in P's precision
    and the stall rule.  Returns (the best-checked x, its gap, steps)."""
    n = P.A_rows.shape[0]
    L = control_mod.lipschitz(P, n) + lam2
    x = torch.zeros(n, device=b.device) if x0 is None else x0.clone()
    y, t = x.clone(), 1.0
    best, x_best, stall = math.inf, x.clone(), 0
    k = 0
    while k < solver["max_iters"]:
        g = P.atr(P.ax(y) - b) + lam2 * y
        x_new = torch.clamp(y - g / L - lam1 / L, min=0.0)
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
            gap = gap32(P, b, lam1, lam2, x)
            if gap < best:
                best, x_best, stall = gap, x.clone(), 0
            else:
                stall += 1
            if best <= tol or (solver.get("stall_checks", 0)
                               and stall >= solver["stall_checks"]):
                break
    return x_best, best, k


def control(inst, config: dict, traffic: dict) -> dict:
    """A certified solve, one precision down (``benchlib/control.py``'s
    steps): projected FISTA with its products and checks in TF32, a
    float32 polish on its support (projected FISTA, 3000 steps) in place
    of the f64 one, a float32 certificate in place of the f64 one.  No
    screen: nothing is frozen.  The output ``judge`` reads."""
    en = data_en.nonneg(inst, config)
    tol, lam2 = float(config["tol"]), float(config["lam2"])
    x, _, _ = fista(control_mod.Products(en.A_rows, "tf32"), en.b, en.lam1,
                    lam2, traffic["solver"], tol)
    xp = torch.zeros_like(x)
    S = torch.nonzero(x).flatten()
    if S.numel():
        P = control_mod.Products(en.A_rows[S].contiguous(), "f32")
        xs, _, _ = fista(P, en.b, en.lam1, lam2,
                         {"max_iters": 3000, "gap_every": 3000}, 0.0,
                         x0=x[S])
        xp[S] = xs
    c = gap32(control_mod.Products(en.A_rows, "f32"), en.b, en.lam1, lam2,
              xp)
    return {"x32": x.cpu().numpy(),
            "x64": xp.cpu().numpy().astype(np.float64), "cert": c}
