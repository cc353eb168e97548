"""A whole run on the CPU, past the look for a card, with the timed path
broken underneath: ``correct`` must come out false for each fault a cell
can have, and true for the sound program.  The program's kernels run
their plain versions here; the sizes are small, the grids, settings and
limits the cells' own."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import convex_optimization_tpu_torch as cot
from benchlib import cell_run, spec

CPU = torch.device("cpu")
SIZES = {"lasso-10kx100k": (300, 1500), "lasso-5kx50k": (200, 1000)}


def small(name):
    c = spec.find_cell(name)
    m, n = SIZES[c.config["name"]]
    return dataclasses.replace(c, config={**c.config, "m": m, "n": n},
                               traffic={**c.traffic, "instances": 1})


def run(cell, seed=2**33 + 77):
    res, lines = cell_run.run(cot, cell, seed=seed, seconds=0.0,
                              trace=False, device=CPU,
                              t_process=time.perf_counter())
    return res


def unchanged_sweep(A_t, x, r, *args, **kw):
    """K1 that returns its state unchanged."""
    return x.clone(), r.clone()


def unchanged_fista_step(problem, L_total, state, cfg):
    return state._replace(k=state.k + 1)


def altered_polish(orig):
    def polish(*a, **kw):
        pr = orig(*a, **kw)
        x = pr.x.copy()
        j = int(np.flatnonzero(x)[0])
        x[j] += 1e-3 * max(1.0, abs(x[j]))
        return pr._replace(x=x)
    return polish


def altered_path(orig):
    def lambda_path(*a, **kw):
        res = orig(*a, **kw)
        xs = res.xs.clone()
        k = int(torch.nonzero(res.converged).flatten()[-1])
        j = int(torch.nonzero(xs[k]).flatten()[0])
        xs[k, j] += 1e-3 * max(1.0, float(xs[k, j].abs()))
        return res._replace(xs=xs)
    return lambda_path


def half_batch(orig):
    """K5 that leaves the second half of the batch's points unsolved."""
    def batch_sweep_t(A_t, X, R, *a, **kw):
        Xn, Rn = orig(A_t, X, R, *a, **kw)
        h = X.shape[1] // 2
        Xn, Rn = Xn.clone(), Rn.clone()
        Xn[:, h:] = X[:, h:]
        Rn[h:] = R[h:]
        return Xn, Rn
    return batch_sweep_t


@pytest.mark.parametrize("name", ["lasso-10kx100k.bcd-cert",
                                  "lasso-10kx100k.fista-cert"])
def test_cert_cells(name, monkeypatch):
    cell = small(name)
    assert run(cell)["correct"] is True
    with monkeypatch.context() as mp:
        if "bcd" in name:
            mp.setattr(cot.solvers.bcd, "sweep_t", unchanged_sweep)
        else:
            mp.setattr(cot.solvers.fista, "fista_step", unchanged_fista_step)
        assert run(cell)["correct"] is False
    with monkeypatch.context() as mp:
        mp.setattr(cot, "polish_support", altered_polish(cot.polish_support))
        res = run(cell)
        assert res["correct"] is False and res["failed"] == res["attempted"]


@pytest.mark.parametrize("name", ["lasso-5kx50k.batch-path",
                                  "lasso-5kx50k.fista-path"])
def test_path_cells(name, monkeypatch):
    cell = small(name)
    assert run(cell)["correct"] is True
    with monkeypatch.context() as mp:
        mp.setattr(cot, "lambda_path", altered_path(cot.lambda_path))
        assert run(cell)["correct"] is False
    if "batch" in name:
        with monkeypatch.context() as mp:
            mp.setattr(cot.solvers.batched_path, "batch_sweep_t",
                       half_batch(cot.solvers.batched_path.batch_sweep_t))
            assert run(cell)["correct"] is False
    else:
        with monkeypatch.context() as mp:
            mp.setattr(cot.solvers.fista, "fista_step", unchanged_fista_step)
            assert run(cell)["correct"] is False
