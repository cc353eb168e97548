"""The FISTA lambda path and ``solve``'s default method in the port (plain
versions on the CPU) against the JAX package on the same numpy arrays.

Tolerances and why: the port's steps run through K2/K3's plain versions
(the witness summed in f64) and the JAX package's through XLA dots, so the
iterates agree to f32 rounding and a stall or convergence test may end a
point one check apart.  So: the same converged flags and supports (|x| >
1e-4), every converged point's f64 gap (the JAX package's own, at the
port's x) <= 2 tol, x within 5e-3 (two certified iterates, as the batched
path's tests allow), step counts within one check (ISTA, whose gap
creeps down to tol over thousands of steps, within 5 %).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu as co
from convex_optimization_tpu.core.datagen import (
    make_lasso_instance_host as j_make_host,
)
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from tests.torch_threads import worker_threads  # noqa: F401

M, N = 64, 256
PATH_CFG = dict(tol=1e-5, max_iters=4000, gap_every=10, stall_checks=20)


def _pair(seed, kind, lam2=0.0, ngroups=0):
    """The JAX package's host instance and the port's problem on its numpy
    arrays."""
    j_inst, A, b = j_make_host(seed, M, N, penalty_kind=kind, lam2=lam2,
                               ngroups=ngroups)
    jp = j_inst.problem
    tp = problem_from_numpy(A, b, kind, float(jp.penalty.lam1), lam2=lam2,
                            ngroups=ngroups, device="cpu")
    return jp, tp


def _same_path(res, j_res, jp, tol, steps_rtol=0.0):
    np.testing.assert_allclose(res.lambdas.numpy(),
                               np.asarray(j_res.lambdas), rtol=1e-6)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(j_res.converged))
    assert bool(res.converged.all())
    for l, lam in enumerate(res.lambdas.tolist()):
        gap = co.duality_gap(jp.with_lam1(lam),
                             jnp.asarray(res.xs[l].numpy()), precise=True)
        assert float(gap.rel_gap) <= 2 * tol, (l, gap)
    xs, j_xs = res.xs.numpy(), np.asarray(j_res.xs)
    np.testing.assert_array_equal(np.abs(xs) > 1e-4, np.abs(j_xs) > 1e-4)
    np.testing.assert_allclose(xs, j_xs, rtol=0, atol=5e-3)
    j_iters = np.asarray(j_res.iters)
    assert (np.abs(np.asarray(res.iters) - j_iters)
            <= np.maximum(PATH_CFG["gap_every"], steps_rtol * j_iters)).all()


@pytest.mark.parametrize("method", ["fista", "ista"])
@pytest.mark.parametrize("kind,lam2,ngroups", [("l1", 0.0, 0),
                                               ("nonneg_l1", 0.01, 0),
                                               ("group_l2", 0.0, 32)])
def test_fista_path_matches_jax(method, kind, lam2, ngroups):
    jp, tp = _pair(32, kind, lam2, ngroups)
    j_res = j_lambda_path(jp, JSolverConfig(**PATH_CFG), path_len=6,
                          lam_min_frac=0.05, method=method)
    res = cot.lambda_path(tp, SolverConfig(**PATH_CFG), path_len=6,
                          lam_min_frac=0.05, method=method)
    assert res.method_used == j_res.method_used == method
    _same_path(res, j_res, jp, PATH_CFG["tol"])
    assert res.sweeps == int(res.iters.sum())


def test_ista_path_runs_momentum_as_cfg_says():
    """The JAX package's 'ista' path never sets momentum=False: with the
    default config it is the FISTA path step for step, and only
    cfg.momentum=False makes it ISTA (then slower, in both packages)."""
    jp, tp = _pair(33, "l1")
    cfg = SolverConfig(**PATH_CFG)
    fista = cot.lambda_path(tp, cfg, path_len=4, lam_min_frac=0.1)
    ista = cot.lambda_path(tp, cfg, path_len=4, lam_min_frac=0.1,
                           method="ista")
    assert fista.method_used == "fista"
    assert torch.equal(ista.xs, fista.xs)
    assert torch.equal(ista.iters, fista.iters)
    slow = cot.lambda_path(tp, dataclasses.replace(cfg, momentum=False),
                           path_len=4, lam_min_frac=0.1, method="ista")
    j_slow = j_lambda_path(jp, JSolverConfig(**PATH_CFG, momentum=False),
                           path_len=4, lam_min_frac=0.1, method="ista")
    _same_path(slow, j_slow, jp, PATH_CFG["tol"], steps_rtol=0.05)
    assert slow.sweeps > fista.sweeps


def test_fista_path_warm_starts_from_the_last_iterate():
    """Each point starts at the previous point's last iterate: solving a
    point alone from that iterate reproduces it."""
    _, tp = _pair(34, "l1")
    cfg = SolverConfig(**PATH_CFG)
    res = cot.lambda_path(tp, cfg, path_len=3, lam_min_frac=0.2)
    lam = float(res.lambdas[2])
    alone = cot.solve(tp.with_lam1(lam), x0=res.xs[1], cfg=cfg)
    assert alone.iterations == int(res.iters[2])
    # the path returns the LAST iterate; solve returns the best one
    assert alone.history["rel_gap"][-1] == pytest.approx(
        float(res.gaps[2]), rel=1e-6)


def test_fista_cv_matches_jax():
    """cv_lambda_path(method="fista"): each fold runs the FISTA path on a
    masked copy in both packages: the same indices, val_mse to rtol 1e-3
    (f32 paths that end on the same tolerance), the refit at best_lambda
    within 5e-3."""
    from convex_optimization_tpu.solvers.cv import (
        cv_lambda_path as j_cv_lambda_path,
    )

    jp, tp = _pair(36, "l1")
    j_res = j_cv_lambda_path(jp, JSolverConfig(**PATH_CFG), k=3, path_len=4,
                             lam_min_frac=0.1, seed=3, method="fista")
    res = cot.cv_lambda_path(tp, SolverConfig(**PATH_CFG), k=3, path_len=4,
                             lam_min_frac=0.1, seed=3, method="fista")
    assert res.method_used == j_res.method_used == "fista"
    np.testing.assert_allclose(res.val_mse.numpy(),
                               np.asarray(j_res.val_mse), rtol=1e-3)
    assert (res.best_index, res.one_se_index) == \
        (j_res.best_index, j_res.one_se_index)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j_res.x), rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 0.05)])
def test_solve_default_method_matches_jax(kind, lam2):
    """solve(problem) with no method runs FISTA in both packages: the same
    method, step counts within one check, both certified in f64."""
    jp, tp = _pair(35, kind, lam2)
    kw = dict(tol=1e-5, max_iters=5000)
    _build.reset_launches()
    res = cot.solve(tp, **kw)
    j_res = co.solve(jp, **kw)
    assert res.method == j_res.method == "fista"
    assert abs(res.iterations - j_res.iterations) <= 10
    assert res.converged and j_res.converged
    for x in (jnp.asarray(res.x.numpy()), j_res.x):
        assert float(co.duality_gap(jp, x, precise=True).rel_gap) <= 2e-5
    assert sum(_build.launches.values()) == 0
