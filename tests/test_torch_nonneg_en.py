"""Config 3, the nonnegative elastic net with gap-safe screening at every
check, through the port's normal path (``solve(bcd_pallas,
screen_every=1)`` on the plain kernels, then ``polish_support``) against
the plain reference of ``tests/reference_en.py`` (f64, written from the
augmented lasso, nothing of the port), at 200 x 1000 and three seeds:

  * the polished x is >= 0 and the reference certifies it to 1e-6;
  * its objective is within 1e-7 relative of the reference's projected
    coordinate descent (solved to a 1e-12 gap: the port's certificate
    bounds its excess objective by 1e-6, and it reads ~1e-14 here);
  * every column the solve's final mask froze is exactly 0 in the
    reference's solution (gap-safe: frozen columns are zero at the
    optimum);
  * the screen's counters: ``Result.kept_col_sweeps`` equals the recount
    from the history's per-check ``kept``, and the spans carry the same
    numbers; a screened check still makes one ``cot.sync``;
  * with screening off there is no mask, no count and no ``kept``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.utils import trace
from tests import reference_en as ref
from tests.torch_threads import worker_threads  # noqa: F401

M, N, LAM2, TOL = 200, 1000, 1e-3, 1e-6
SEEDS = (0, 1, 2)
SOLVER = dict(tol=TOL, max_iters=20_000, gap_every=10, stall_checks=15,
              block_size=128)


def _problem(seed):
    inst, _, _ = make_lasso_instance_host(seed, M, N,
                                          penalty_kind="nonneg_l1",
                                          lam2=LAM2, device="cpu")
    return inst.problem


def _traced_solve(problem, method, **kw):
    """The solve under a CPU profiler: (its Result, its recorded spans)."""
    trace.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = cot.solve(problem, method, **SOLVER, **kw)
    recs = trace.RECORDER.records(trace.RECORDER.session)
    trace.RECORDER.clear()
    return res, recs


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    p = _problem(request.param)
    lam1 = float(p.penalty.lam1)
    res, recs = _traced_solve(p, "bcd_pallas", screen_every=1)
    pr = cot.polish_support(p, res.x, tol=TOL)
    x_cd = ref.solve_cd(p.A_rows, p.b, lam1, LAM2)
    return dict(p=p, lam1=lam1, res=res, recs=recs, pr=pr, x_cd=x_cd)


def test_polished_x_is_nonneg_and_certified_by_the_reference(case):
    p, pr = case["p"], case["pr"]
    assert np.all(pr.x >= 0) and np.count_nonzero(pr.x) > 0
    assert bool((case["res"].x >= 0).all())
    gap = ref.rel_gap(p.A_rows, p.b, case["lam1"], LAM2, pr.x)
    assert 0.0 <= gap <= TOL
    assert 0.0 <= ref.rel_gap(p.A_rows, p.b, case["lam1"], LAM2,
                              case["x_cd"]) <= 1e-12


def test_objective_matches_the_plain_solver(case):
    p = case["p"]
    got = ref.objective(p.A_rows, p.b, case["lam1"], LAM2, case["pr"].x)
    want = ref.objective(p.A_rows, p.b, case["lam1"], LAM2, case["x_cd"])
    assert abs(got - want) <= 1e-7 * abs(want)


def test_frozen_columns_are_zero_in_the_plain_solution(case):
    res = case["res"]
    keep = res.keep_mask
    assert keep.dtype == torch.bool and keep.shape == (N,)
    frozen = ~keep.numpy()
    assert 0 < frozen.sum() < N and frozen.sum() == res.screened
    assert np.all(case["x_cd"][frozen] == 0.0)
    assert np.all(case["pr"].x[frozen] == 0.0)


def _recount(history) -> int:
    """Sum over the checks of each check's kept columns times the sweeps
    run before the next check (the first check is at sweep 0)."""
    it, kept = history["iteration"], history["kept"]
    return int(sum(int(kept[i]) * int(it[i + 1] - it[i])
                   for i in range(len(it) - 1)))


def test_kept_col_sweeps_recounts_from_the_history(case):
    res, recs = case["res"], case["recs"]
    h = res.history
    assert len(h["kept"]) == len(h["iteration"])
    assert int(h["kept"][-1]) == N - res.screened
    assert np.all(np.diff(h["kept"]) <= 0)        # the mask only tightens
    assert 0 < res.kept_col_sweeps == _recount(h) < N * res.iterations
    loops = [r for r in recs if r["name"] == "cot.loop"]
    assert [r["attrs"] for r in loops] == [
        {"iterations": res.iterations,
         "kept_col_sweeps": res.kept_col_sweeps}]
    checks = [r for r in recs if r["name"] == "cot.check"]
    assert [r["attrs"]["kept"] for r in checks] == list(h["kept"])


def test_a_screened_check_makes_one_sync(case):
    recs = case["recs"]
    checks = [i for i, r in enumerate(recs) if r["name"] == "cot.check"]
    syncs = [r for r in recs if r["name"] == "cot.sync"]
    assert len(checks) == len(case["res"].history["iteration"]) > 1
    assert len(syncs) == len(checks)
    assert sorted(r["parent"] for r in syncs) == checks


@pytest.mark.parametrize("method", ["bcd_pallas", "fista"])
def test_screened_fista_and_bcd_count_alike(method):
    """FISTA's loop shares the check and counts its steps the same way."""
    p = _problem(SEEDS[0])
    res, _ = _traced_solve(p, method, screen_every=1)
    assert res.kept_col_sweeps == _recount(res.history) > 0
    assert res.keep_mask is not None and not bool(
        (res.x[~res.keep_mask] != 0).any())


@pytest.mark.parametrize("method", ["bcd_pallas", "fista"])
def test_screen_off_has_no_mask_and_no_count(method):
    p = _problem(SEEDS[0])
    res, recs = _traced_solve(p, method, screen_every=0)
    assert res.keep_mask is None and res.kept_col_sweeps == 0
    assert res.screened == 0 and "kept" not in res.history
    assert all("kept" not in r["attrs"] for r in recs
               if r["name"] == "cot.check")
    syncs = [r for r in recs if r["name"] == "cot.sync"]
    assert len(syncs) == len(res.history["iteration"])
