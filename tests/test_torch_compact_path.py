"""The compacting lambda path (``lambda_path(compact=True)``) of the port
(plain versions on the CPU) against the JAX package's on the same numpy
arrays.

Tolerances and why: each point screens at its warm start, and the kept
count is rounded up to a bucket (64 columns at n = 384), so the rounding
differences between the port's witness (K3's plain version, summed in f64)
and the JAX package's (f32) do not move a bucket here: ``kept`` agrees
exactly.  The FISTA solves on the slabs then agree to f32 rounding: x
within the JAX package's own tolerances between its compact and plain
paths (5e-5 for l1 and nonneg_l1, 5e-4 for group_l2), and every gap at
the f32 floor its test allows (1e-4: the deep points run to max_iters at
the floor, where the last iterate's gap is rounding noise).
"""

import jax
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core import objective as t_objective
from convex_optimization_tpu_torch.core.problem import (
    Problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from tests.torch_threads import worker_threads  # noqa: F401


def _pair(seed, m, n, kind="l1", ngroups=0):
    jp = make_lasso_instance(jax.random.PRNGKey(seed), m, n,
                             penalty_kind=kind, ngroups=ngroups).problem
    tp = problem_from_numpy(np.array(jp.A), np.array(jp.b), kind,
                            float(jp.penalty.lam1), ngroups=ngroups,
                            device="cpu")
    return jp, tp


# the JAX package's compact-path instances (tests/test_fista.py:
# test_lambda_path_compact_matches_plain, test_lambda_path_compact_group)
# and a nonneg_l1 one on the first's data
CASES = {
    "l1": (17, "l1", 0, 6, dict(tol=1e-6, max_iters=4000, gap_every=10)),
    "nonneg_l1": (17, "nonneg_l1", 0, 6,
                  dict(tol=1e-6, max_iters=4000, gap_every=10)),
    "group_l2": (33, "group_l2", 48, 5,
                 dict(tol=1e-6, max_iters=4000, gap_every=5,
                      stall_checks=10)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compact_path_matches_jax(case):
    seed, kind, ngroups, path_len, kw = CASES[case]
    jp, tp = _pair(seed, 96, 384, kind, ngroups)
    j_res = j_lambda_path(jp, JSolverConfig(**kw), path_len=path_len,
                          compact=True)
    res = cot.lambda_path(tp, SolverConfig(**kw), path_len=path_len,
                          compact=True)
    assert res.method_used == j_res.method_used == "fista_compact"
    np.testing.assert_allclose(res.lambdas.numpy(),
                               np.asarray(j_res.lambdas), rtol=1e-5)
    np.testing.assert_array_equal(res.kept.numpy(), np.asarray(j_res.kept))
    gsize = 384 // ngroups if ngroups else 1
    assert all(int(k) % gsize == 0 for k in res.kept)
    # compaction bites at the sparse end of the path
    assert int(res.kept[0]) < 384
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(j_res.xs),
                               atol=5e-4 if ngroups else 5e-5)
    assert float(res.gaps.max()) <= 1e-4
    assert float(np.max(np.asarray(j_res.gaps))) <= 1e-4
    assert res.sweeps == int(res.iters.sum())


@pytest.mark.parametrize("case", ["l1", "group_l2"])
def test_compact_path_matches_plain_path(case):
    # the JAX package's own check, on the port alone: compaction does not
    # change the path's solutions (its 5e-5 for l1, 5e-4 for group_l2)
    seed, kind, ngroups, path_len, kw = CASES[case]
    _, tp = _pair(seed, 96, 384, kind, ngroups)
    cfg = SolverConfig(**kw)
    plain = cot.lambda_path(tp, cfg, path_len=path_len)
    comp = cot.lambda_path(tp, cfg, path_len=path_len, compact=True)
    assert plain.kept is None
    np.testing.assert_allclose(comp.xs.numpy(), plain.xs.numpy(),
                               atol=5e-5 if kind == "l1" else 5e-4)


def test_compact_path_makes_no_torch_mv_over_A(monkeypatch):
    """The screen's r and z come from the K2/K3 wrappers and the slab's
    warm residual from K2: Problem.residual and dual_witness (torch.mv)
    are never called."""
    def no_mv(*a, **kw):
        raise AssertionError("a torch.mv over A on the compact path")

    seed, kind, ngroups, path_len, kw = CASES["l1"]
    _, tp = _pair(seed, 96, 384, kind, ngroups)
    monkeypatch.setattr(Problem, "residual", no_mv)
    monkeypatch.setattr(t_objective, "dual_witness", no_mv)
    monkeypatch.setattr(fista_mod, "dual_witness", no_mv)
    res = cot.lambda_path(tp, SolverConfig(**kw), path_len=path_len,
                          compact=True, method="bcd_ws")
    assert res.method_used == "fista_compact"


def test_compact_path_options():
    _, tp = _pair(17, 32, 64)
    with pytest.raises(ValueError, match="compact"):
        cot.lambda_path(tp, SolverConfig(), path_len=3, compact=True,
                        method="bcd_batch")
    with pytest.raises(NotImplementedError, match="single-device"):
        cot.lambda_path(tp, SolverConfig(), path_len=3, compact=True,
                        mesh=object())
