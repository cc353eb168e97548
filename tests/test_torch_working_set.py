"""The working-set solver (``fista_ws``, ``bcd_ws``) of the port (plain
versions on the CPU) against the JAX package's on the same numpy arrays.

The JAX package routes its working set through the Pallas kernels only on
a TPU, so these tests call its ``solve_working_set(force_kernels=True)``
(interpret mode, as its own ``tests/test_fista.py`` does): only then is
its ``inner='bcd'`` a BCD, as the port's is on every device.

Tolerances and why: both run the same rounds on the same f32 data, but the
port's witness is summed in f64 (K3's plain version) and the JAX
package's in f32, so a column whose sphere test sits at its threshold can
be kept by one and not the other: each screen's working set agrees within
one bucket (128 columns) and the rounds agree exactly; x within 5e-4 (the
JAX package's own tolerance between a working-set and a plain solve);
both full-width rel_gaps <= tol; the same support after each package's
f64 polish.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import convex_optimization_tpu.solvers.working_set as jws_mod
from convex_optimization_tpu.api import solve as j_solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.core.objective import duality_gap as j_gap
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
from convex_optimization_tpu.solvers.polish import (
    polish_support as j_polish,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core import objective as t_objective
from convex_optimization_tpu_torch.core.problem import (
    Problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
from convex_optimization_tpu_torch.solvers import fista as fista_mod
from convex_optimization_tpu_torch.solvers import working_set as ws
from convex_optimization_tpu_torch.solvers.common import SolverConfig

BUCKET = 128


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed, m, n, kind="l1", ngroups=0):
    """The JAX package's instance and the port's problem on its arrays."""
    jp = make_lasso_instance(jax.random.PRNGKey(seed), m, n,
                             penalty_kind=kind, ngroups=ngroups).problem
    tp = problem_from_numpy(np.array(jp.A), np.array(jp.b), kind,
                            float(jp.penalty.lam1), ngroups=ngroups,
                            device="cpu")
    return jp, tp


def _support(x, gsize):
    """Active coordinates (|x| > 1e-8), or active groups for gsize > 1."""
    a = np.abs(np.asarray(x, np.float64))
    if gsize > 1:
        return a.reshape(-1, gsize).sum(axis=1) > 1e-8
    return a > 1e-8


@contextlib.contextmanager
def _screen_sizes(monkeypatch, gsize):
    """Record the working-set size of every full-width screen, in both
    packages."""
    sizes = {"jax": [], "port": []}
    j_screen = jws_mod._screen_kernel_j

    def j_rec(problem, x, A_t):
        keep, info, r = j_screen(problem, x, A_t)
        k = np.asarray(keep)
        if gsize > 1:
            k = np.repeat(k.reshape(-1, gsize).any(axis=1), gsize)
        sizes["jax"].append(int(k.sum()))
        return keep, info, r

    t_screen = ws.screen

    def t_rec(*a, **kw):
        out = t_screen(*a, **kw)
        sizes["port"].append(len(out[0]))
        return out

    monkeypatch.setattr(jws_mod, "_screen_kernel_j", j_rec)
    monkeypatch.setattr(ws, "screen", t_rec)
    yield sizes


@pytest.mark.parametrize("inner", ["fista", "bcd"])
@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("nonneg_l1", 0),
                                          ("group_l2", 128)])
def test_working_set_matches_jax(monkeypatch, inner, kind, ngroups):
    # the JAX package's kernel-routed working-set instance
    # (tests/test_fista.py:test_working_set_kernel_routed)
    jp, tp = _pair(63, 128, 1024, kind, ngroups)
    gsize = 1024 // ngroups if ngroups else 1
    tol = 1e-5
    with _screen_sizes(monkeypatch, gsize) as sizes:
        xj, ij, mj = jws_mod.solve_working_set(
            jp, JSolverConfig(tol=tol, max_iters=5000), bucket=BUCKET,
            inner=inner, force_kernels=True)
        xt, it, mt = ws.solve_working_set(
            tp, SolverConfig(tol=tol, max_iters=5000), bucket=BUCKET,
            inner=inner)
    assert mj["kernel_routed"]
    assert float(ij.rel_gap) <= tol and float(it.rel_gap) <= tol
    assert mt["rounds"] == mj["rounds"], (mt, mj)
    # the same screens, each within one bucket (module docstring)
    assert len(sizes["port"]) == len(sizes["jax"]), sizes
    for sp, sj in zip(sizes["port"], sizes["jax"]):
        assert abs(sp - sj) <= BUCKET, sizes
    assert abs(mt["ws_size"] - mj["ws_size"]) <= BUCKET
    assert mt["ws_size"] < tp.n and mt["ws_size"] % gsize == 0
    assert set(mt) == {"rounds", "inner_iters", "wall_s", "setup_s",
                       "burn_s", "ws_size"}
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=5e-4)
    # an honest full-width gap: the JAX package's own, at the port's x
    assert float(j_gap(jp, jax.numpy.asarray(xt.numpy())).rel_gap) \
        <= 1.5 * tol
    pt = cot.polish_support(tp, xt, tol=1e-6)
    pj = j_polish(jp, xj, tol=1e-6)
    assert pt.rel_gap <= 1e-6 and pj.rel_gap <= 1e-6
    np.testing.assert_array_equal(_support(pt.x, gsize),
                                  _support(pj.x, gsize))


@pytest.mark.parametrize("method", ["fista_ws", "bcd_ws"])
def test_solve_working_set_certify(method):
    # tests/test_fista.py:test_working_set_certify's instance
    jp, tp = _pair(62, 96, 768)
    res = cot.solve(tp, method, tol=1e-8, max_iters=3000, stall_checks=10,
                    certify=True)
    assert res.method == method
    assert res.converged and res.rel_gap <= 1e-8
    assert res.x.dtype == torch.float64
    # the JAX package's f64 gap at the port's certified x
    assert float(j_gap(jp, jax.numpy.asarray(res.x.numpy()),
                       precise=True).rel_gap) <= 2e-8
    for key in ("rounds", "inner_iters", "ws_size", "burn_s"):
        assert key in res.history
    assert res.iterations == res.history["inner_iters"]


@pytest.mark.parametrize("method", ["fista_ws", "bcd_ws"])
def test_solve_working_set_matches_full_solve(method):
    # tests/test_fista.py:test_working_set_matches_full_solve's instance:
    # the working-set solve and the JAX package's plain FISTA, two
    # tol=1e-5 solves, agree within the gap-implied ball (its 5e-4)
    jp, tp = _pair(61, 128, 1024)
    ref = j_solve(jp, "fista", tol=1e-5, max_iters=5000)
    res = cot.solve(tp, method, tol=1e-5, max_iters=5000)
    assert res.converged, res.rel_gap
    assert res.history["ws_size"] < tp.n
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=5e-4)


def test_working_set_path_matches_jax():
    # tests/test_fista.py:test_lambda_path_working_set_matches_fista_path's
    # instance: the JAX package's fista_ws path (its XLA route on the CPU,
    # the same FISTA steps) point for point: kept within one bucket, x
    # within its 5e-4
    jp, tp = _pair(27, 96, 384)
    jcfg = JSolverConfig(tol=1e-6, max_iters=4000, gap_every=5)
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=5)
    j_res = j_lambda_path(jp, jcfg, path_len=5, method="fista_ws")
    res = cot.lambda_path(tp, cfg, path_len=5, method="fista_ws")
    assert res.method_used == "fista_ws" and res.kept is not None
    np.testing.assert_allclose(res.lambdas.numpy(),
                               np.asarray(j_res.lambdas), rtol=1e-5)
    assert np.all(np.abs(res.kept.numpy() - np.asarray(j_res.kept))
                  <= BUCKET)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(j_res.xs),
                               atol=5e-4)
    assert res.sweeps == int(res.iters.sum())


def test_bcd_ws_path_matches_fista_path():
    # the bcd_ws path has no JAX counterpart off the TPU (its CPU route is
    # FISTA), so it is held to the JAX FISTA path as the JAX package holds
    # its BCD paths (tests/test_fista.py:test_lambda_path_bcd_matches_fista):
    # every gap within max(3 x the FISTA path's worst, 2e-6), the f32
    # floor of the deep points; each returned gap honest (the JAX
    # package's f64 gap at the port's x within 2x it); at every point the
    # same support after each package's f64 polish.  (x itself is not
    # compared: near lam_max a 1e-6 relative gap is a loose absolute one,
    # and the two algorithms' certified points differ there by ~7e-3)
    jp, tp = _pair(27, 96, 384)
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=5)
    ref = j_lambda_path(jp, JSolverConfig(tol=1e-6, max_iters=4000,
                                          gap_every=5), path_len=5)
    res = cot.lambda_path(tp, cfg, path_len=5, method="bcd_ws")
    assert res.method_used == "bcd_ws" and res.kept is not None
    floor = max(3.0 * float(np.max(np.asarray(ref.gaps))), 2e-6)
    assert float(res.gaps.max()) <= floor, (res.gaps, ref.gaps)
    for i, lam in enumerate(res.lambdas.tolist()):
        jp_i = jp.with_lam1(lam)
        g64 = float(j_gap(jp_i, jax.numpy.asarray(res.xs[i].numpy()),
                          precise=True).rel_gap)
        assert g64 <= 2.0 * float(res.gaps[i]) + 1e-7, (i, g64, res.gaps)
        pt = cot.polish_support(tp.with_lam1(lam), res.xs[i], tol=1e-6)
        pj = j_polish(jp_i, ref.xs[i], tol=1e-6)
        assert pt.rel_gap <= 1e-6 and pj.rel_gap <= 1e-6
        np.testing.assert_array_equal(_support(pt.x, 1), _support(pj.x, 1))


@pytest.mark.parametrize("inner", ["fista", "bcd"])
def test_compact_solves_never_touch_full_A(monkeypatch, inner):
    """The audit the JAX package makes with a NaN placeholder for A: no
    kernel launched inside a compact solve is given the full A_t, and
    nothing on the path computes A x or A^T r outside the kernels'
    wrappers (Problem.residual and dual_witness are torch.mv)."""
    jp, tp = _pair(63, 128, 1024)
    n_full = tp.n
    calls = []          # (phase, columns of the A_t a wrapper was given)
    phase = ["outer"]

    def kernel(name, fn):
        def rec(A_t, *a, **kw):
            calls.append((phase[-1], name, A_t.shape[0] * A_t.shape[1]))
            return fn(A_t, *a, **kw)
        return rec

    def solver(fn):
        def rec(problem, *a, **kw):
            phase.append("compact" if problem.n < n_full else "full")
            try:
                return fn(problem, *a, **kw)
            finally:
                phase.pop()
        return rec

    for mod in (fista_mod, bcd_mod, ws):
        for name in ("ax_minus_b_t", "neg_at_r_t"):
            monkeypatch.setattr(mod, name, kernel(name, getattr(mod, name)))
    for name in ("sweep_t", "sweep_tiled_t"):
        monkeypatch.setattr(bcd_mod, name, kernel(name,
                                                  getattr(bcd_mod, name)))
    monkeypatch.setattr(ws, "block_power_t",
                        kernel("block_power_t", ws.block_power_t))
    monkeypatch.setattr(fista_mod, "fista", solver(fista_mod.fista))
    monkeypatch.setattr(bcd_mod, "bcd", solver(bcd_mod.bcd))

    def no_mv(*a, **kw):
        raise AssertionError("a torch.mv over A on the working-set path")

    monkeypatch.setattr(Problem, "residual", no_mv)
    monkeypatch.setattr(t_objective, "dual_witness", no_mv)
    monkeypatch.setattr(fista_mod, "dual_witness", no_mv)
    x, info, meta = ws.solve_working_set(
        tp, SolverConfig(tol=1e-5, max_iters=5000), bucket=BUCKET,
        inner=inner)
    assert float(info.rel_gap) <= 1e-5
    compact = [c for c in calls if c[0] == "compact"]
    assert compact, calls
    assert all(cols < n_full for _, _, cols in compact), compact
    # the screens run on the full A_t, outside the compact solves
    assert any(p == "outer" and cols == n_full for p, _, cols in calls)
    if inner == "bcd":
        # the sweeps ran on the slab, with K4's constants of the slab
        assert "sweep_t" in {c[1] for c in compact}
        assert any(name == "block_power_t" and cols < n_full
                   for _, name, cols in calls)


def test_full_width_fallback_matches_jax():
    """k_b >= n: a working set that rounds up to every column falls back to
    the full-width FISTA (stall rule 5) and then re-screens, as in the JAX
    package; rounds 1, and ws_size describes the final screen."""
    jp, tp = _pair(5, 96, 128)
    kw = dict(tol=1e-7, max_iters=3000, gap_every=10)
    xj, ij, mj = jws_mod.solve_working_set(
        jp, JSolverConfig(**kw), bucket=BUCKET, init_iters=10,
        force_kernels=True)
    xt, it, mt = ws.solve_working_set(tp, SolverConfig(**kw), bucket=BUCKET,
                                      init_iters=10)
    assert mt["rounds"] == mj["rounds"] == 1, (mt, mj)
    # tol is below the f32 floor, so the fallback ends on its stall rule,
    # which rounding can move by a check or two
    assert mt["inner_iters"] > 10           # the fallback ran
    assert abs(mt["inner_iters"] - mj["inner_iters"]) <= 2 * 10
    assert abs(mt["ws_size"] - mj["ws_size"]) <= BUCKET
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=5e-4)
    assert float(it.rel_gap) <= 1e-5 and float(ij.rel_gap) <= 1e-5


def test_working_set_rejects_unknown_inner():
    _, tp = _pair(5, 32, 64)
    with pytest.raises(ValueError, match="inner"):
        ws.solve_working_set(tp, SolverConfig(), inner="nope")


CV_CFG = dict(tol=1e-6, max_iters=6000, gap_every=10, stall_checks=20)


@pytest.fixture(scope="module")
def cv_default():
    """tests/test_cv.py's instance and the port's default CV route (the
    batched kernels) on it."""
    jp = make_lasso_instance(jax.random.PRNGKey(33), 96, 320,
                             noise_std=0.05).problem
    tp = problem_from_numpy(np.array(jp.A), np.array(jp.b), "l1",
                            float(jp.penalty.lam1), device="cpu")
    return tp, cot.cv_lambda_path(tp, SolverConfig(**CV_CFG), k=3,
                                  path_len=6, seed=4)


@pytest.mark.parametrize("method", ["fista_ws", "bcd_ws", "admm"])
def test_cv_masked_copy_takes_new_methods(cv_default, method):
    # cv_lambda_path's masked-copy route passes ``method`` to lambda_path,
    # as the JAX package's does: held to the default route as the existing
    # CV test holds the 'bcd' copy route (two certified solvers: held-out
    # MSEs within rtol 1e-3 / atol 2e-3, the same chosen indices)
    tp, ref = cv_default
    cfg = SolverConfig(**CV_CFG)
    res = cot.cv_lambda_path(tp, cfg, k=3, path_len=6, seed=4,
                             method=method)
    assert res.method_used == method
    np.testing.assert_allclose(res.val_mse.numpy(), ref.val_mse.numpy(),
                               rtol=1e-3, atol=2e-3)
    assert (res.best_index, res.one_se_index) == \
        (ref.best_index, ref.one_se_index)
