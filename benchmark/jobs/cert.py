"""A certified solve: ``solve`` in f32 from x0 = 0, then the f64 support
polish, the certificate the user asked for.

Traffic parameters: ``method`` and ``solver`` (keyword arguments of
``solve``); the configuration gives ``tol``.  Each request's outputs are
the solve's f32 x, the polished x and its certificate; the reference
judges every one of them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import reference

METRIC = "cert_s"


class Job:
    def __init__(self, cot, cell, device):
        self.cot = cot
        self.cell = cell
        self.device = device
        self.tol = float(cell.config["tol"])
        self.method = cell.traffic["method"]
        self.solver = dict(cell.traffic["solver"])
        self.problems: list = []
        self.outputs: list = []
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def prepare(self, insts: list) -> None:
        self.problems = [self.cot.make_problem(i.A, i.b, i.lam1)
                         for i in insts]

    def _solve(self, problem, **over):
        return self.cot.solve(problem, self.method, tol=self.tol,
                              **{**self.solver, **over})

    def warmup(self) -> None:
        """The entry at its own shapes, cut to two checks, and one short
        polish (the host library's first call)."""
        problem = self.problems[0]
        res = self._solve(problem, max_iters=2 * self.solver["gap_every"])
        self.cot.polish_support(problem, res.x, tol=self.tol, max_iters=2,
                                max_expand=0)
        self.sync()

    def request(self, clock, i: int) -> dict:
        sync = self.sync
        problem = self.problems[i]
        t0 = clock()
        with record_function("bench.solve"):
            res = self._solve(problem)
            sync()
        t1 = clock()
        with record_function("bench.polish"):
            pr = self.cot.polish_support(problem, res.x, tol=self.tol)
            sync()
        t2 = clock()
        self.outputs.append({
            "instance": i,
            "x32": res.x.detach().to("cpu", torch.float32).numpy(),
            "x64": np.asarray(pr.x, np.float64),
            "cert": float(pr.rel_gap)})
        return {"solve_s": t1 - t0, "polish_s": t2 - t1,
                "iters": int(res.iterations), "kept": int(pr.kept)}

    def free(self) -> None:
        self.problems = []


def judge(inst, config: dict, traffic: dict, out: dict) -> dict:
    """The numbers of one request, from the reference:

    gap        f64 relative gap at the polished x (the certificate's claim)
    cert_err   |the certificate - that gap| / tol
    solve_gap  f64 relative gap at the solve's f32 x
    """
    tol = float(config["tol"])
    gap = reference.rel_gap(inst.A_rows, inst.b, inst.lam1, out["x64"])
    return {"gap": gap,
            "cert_err": abs(out["cert"] - gap) / tol,
            "solve_gap": reference.rel_gap(inst.A_rows, inst.b, inst.lam1,
                                           out["x32"])}
