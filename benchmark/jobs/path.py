"""A warm-started lambda path: ``lambda_path`` over the configuration's
grid (``path_len`` points, geometric from 0.95 lam_max to
``lam_min_frac`` lam_max), from x = 0.

Traffic parameters: ``method`` and ``solver`` (fields of the program's
``SolverConfig``); the configuration gives ``tol`` and the grid.  Each
request's outputs are every point's x, whether the program says it
converged, and the method that ran; the reference judges every point.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import reference

METRIC = "path_s"


class Job:
    def __init__(self, cot, cell, device):
        self.cot = cot
        self.cell = cell
        self.device = device
        cfg = cell.config
        self.path_len = int(cfg["path_len"])
        self.lam_min_frac = float(cfg["lam_min_frac"])
        self.method = cell.traffic["method"]
        common = importlib.import_module(cot.__name__ + ".solvers.common")
        self.solver_cfg = lambda **over: common.SolverConfig(
            tol=float(cfg["tol"]), **{**cell.traffic["solver"], **over})
        self.problems: list = []
        self.outputs: list = []
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def prepare(self, insts: list) -> None:
        self.problems = [self.cot.make_problem(i.A, i.b, i.lam1)
                         for i in insts]

    def _path(self, problem, cfg):
        return self.cot.lambda_path(problem, cfg,
                                    path_len=self.path_len,
                                    lam_min_frac=self.lam_min_frac,
                                    method=self.method)

    def warmup(self) -> None:
        """The entry at its own shapes, each point cut to two checks."""
        gap_every = self.cell.traffic["solver"]["gap_every"]
        self._path(self.problems[0],
                   self.solver_cfg(max_iters=2 * gap_every))
        self.sync()

    def request(self, clock, i: int) -> dict:
        t0 = clock()
        with record_function("bench.path"):
            res = self._path(self.problems[i], self.solver_cfg())
            self.sync()
        t1 = clock()
        self.outputs.append({
            "instance": i,
            "xs": res.xs.detach().to("cpu", torch.float64).numpy(),
            "gaps": res.gaps.detach().to("cpu", torch.float64).numpy(),
            "converged": res.converged.cpu().numpy().astype(bool),
            "method_used": res.method_used})
        return {"path_s": t1 - t0, "iters": int(res.sweeps)}

    def free(self) -> None:
        self.problems = []


def judge(inst, config: dict, traffic: dict, out: dict) -> dict:
    """The numbers of one request, from the reference's own grid:

    gap_conv   the largest f64 relative gap over the points the program
               says converged (0 where none did)
    claim_err  the largest distance, over every point, between the gap
               the program reports and the point's f64 gap (infinite where
               a point is missing)
    gap_med    the median over the points of their f64 gaps: how well the
               path solves as a whole, where a stalled point or two may
               stop above the float32 floor
    fallback   1 where another method ran than the traffic asks for
    """
    lams = reference.lambda_grid(inst.lam_max, int(config["path_len"]),
                                 float(config["lam_min_frac"]))
    gaps = [reference.rel_gap(inst.A_rows, inst.b, float(lam), x)
            for lam, x in zip(lams, out["xs"])]
    conv = out["converged"]
    whole = len(gaps) == len(lams) == len(conv) == len(out["gaps"])
    return {"gap_conv": max((g for g, c in zip(gaps, conv) if c),
                            default=0.0),
            "claim_err": (max(abs(float(c) - g)
                              for c, g in zip(out["gaps"], gaps))
                          if whole else float("inf")),
            "gap_med": float(np.median(gaps)) if whole else float("inf"),
            "fallback": float(out["method_used"] != traffic["method"])}
