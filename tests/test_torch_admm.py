"""ADMM of the port (plain versions on the CPU) against the JAX package's on
the same numpy arrays.

Tolerances and why: in float64 the two loops make the same decisions (the
residual balancing is a discrete choice, but f64 rounding does not reach
its thresholds here), so rho and k agree exactly at every check and z to
1e-8, until the gap reaches 1e-11: there both residuals are rounding
noise and the balancing follows the noise.  The x-update is held to
``numpy.linalg.solve`` (1e-10 of the solution's size, in f64), not V to
V: eigenvector order and signs differ between LAPACK calls, and V diag V^T
does not.  In float32 a rounding can flip one balancing decision
and the iterates part, so f32 runs are held to their certified gap and to
the solution only: the JAX package's own tolerances (2.5e-3 to its FISTA
solution, 5e-3 on the ill-conditioned instance).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu.solvers.admm as j_admm
from convex_optimization_tpu.api import solve as j_solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.core.objective import duality_gap as j_gap
from convex_optimization_tpu.core.problem import make_problem as j_make
from convex_optimization_tpu.models.penalties import (
    group_l2 as j_group_l2,
    l1 as j_l1,
    nonneg_l1 as j_nonneg_l1,
)
from convex_optimization_tpu.solvers.common import (
    History as JHistory,
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch import api
from convex_optimization_tpu_torch.core import objective as t_objective
from convex_optimization_tpu_torch.core.problem import (
    Problem,
    make_penalty,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.solvers import admm as t_admm
from convex_optimization_tpu_torch.solvers.common import SolverConfig


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed, m, n, kind="l1", ngroups=0, lam2=0.0):
    """The JAX package's f32 instance and the port's problem on its
    arrays."""
    jp = make_lasso_instance(jax.random.PRNGKey(seed), m, n,
                             penalty_kind=kind, ngroups=ngroups,
                             lam2=lam2).problem
    tp = problem_from_numpy(np.array(jp.A), np.array(jp.b), kind,
                            float(jp.penalty.lam1), lam2=lam2,
                            ngroups=ngroups, device="cpu")
    return jp, tp


def _pair64(m, n, kind="l1", ngroups=0, lam2=0.0, seed=0):
    """One float64 instance for both packages: the JAX problem and the
    port's (A_t a float64 copy of A^T, one column a block)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, max(1, n // 20), replace=False)] = 1.0
    b = A @ x_true + 0.01 * rng.standard_normal(m)
    z = np.abs(A.T @ b)
    if kind == "group_l2":
        z = np.linalg.norm((A.T @ b).reshape(ngroups, -1), axis=1)
    lam1 = 0.1 * float(z.max())
    j_pen = (j_group_l2(lam1, ngroups) if kind == "group_l2"
             else {"l1": j_l1, "nonneg_l1": j_nonneg_l1}[kind](lam1))
    jp = j_make(jnp.asarray(A), jnp.asarray(b), lam1, lam2=lam2,
                penalty=j_pen)
    tp = Problem(A_t=torch.from_numpy(np.ascontiguousarray(A.T)).view(n, 1, m),
                 b=torch.from_numpy(b),
                 penalty=make_penalty(kind, lam1, ngroups), lam2=lam2)
    return jp, tp, A


@pytest.mark.parametrize("m,n", [(32, 96), (96, 32)])
@pytest.mark.parametrize("host", [False, True])
def test_x_update_exact_both_branches(m, n, host):
    # Woodbury (n > m) and direct (n <= m) against numpy.linalg.solve,
    # float64, both set-ups
    _, tp, A = _pair64(m, n)
    fac = (t_admm.admm_setup_host(tp) if host else t_admm.admm_setup(tp))
    assert fac.use_woodbury == (n > m)
    assert fac.V.dtype == torch.float64 and float(fac.s.min()) >= 0.0
    np.testing.assert_allclose(fac.Atb.numpy(), A.T @ tp.b.numpy(),
                               rtol=1e-12, atol=1e-12)
    q = np.linspace(-1, 1, n)
    for c in (0.7, 1e-3):
        got = t_admm._x_update(tp, fac, torch.from_numpy(q), c).numpy()
        want = np.linalg.solve(A.T @ A + c * np.eye(n), q)
        # 1e-10 relative to the solution (|x| reaches 1e3 at c = 1e-3)
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("m,n,kind,ngroups,lam2", [
    (48, 160, "l1", 0, 0.0),
    (48, 160, "l1", 0, 0.1),            # elastic net
    (48, 160, "nonneg_l1", 0, 0.0),
    (48, 160, "group_l2", 16, 0.0),
    (160, 48, "l1", 0, 0.0),            # n <= m: the direct branch
])
def test_admm_f64_matches_jax_at_every_check(m, n, kind, ngroups, lam2):
    jp, tp, _ = _pair64(m, n, kind, ngroups, lam2, seed=m + n)
    j_fac = j_admm.admm_setup(jp)
    t_fac = t_admm.admm_setup(tp)
    gap_every = 10
    # one check per call: k (and the history) reset, the iterate carried
    j_cfg = JSolverConfig(tol=0.0, max_iters=gap_every, gap_every=gap_every)
    t_cfg = SolverConfig(tol=0.0, max_iters=gap_every, gap_every=gap_every)
    js = j_admm.init_state(jp, None, j_cfg)
    ts = t_admm.init_state(tp, None)
    assert float(ts.rho) == float(js.rho)
    for check in range(1, 16):
        js = j_admm.admm(jp, j_fac, js._replace(
            k=jnp.zeros((), jnp.int32),
            history=JHistory.empty(j_cfg.max_checks, jnp.float64)), j_cfg)
        ts = t_admm.admm(tp, t_fac, ts._replace(k=0), t_cfg)
        assert ts.k == int(js.k) == gap_every
        assert float(ts.rho) == float(js.rho), check
        np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z),
                                   rtol=0, atol=1e-8, err_msg=str(check))
        np.testing.assert_allclose(ts.rel_gap, float(js.rel_gap),
                                   rtol=1e-6, atol=1e-12)
        if float(js.rel_gap) < 1e-11:
            break
    assert check > 3
    # and one whole solve: the same stop, rho and iterate
    cfg_kw = dict(tol=1e-9, max_iters=3000, gap_every=gap_every)
    js = j_admm.admm(jp, j_fac, j_admm.init_state(jp, None,
                                                  JSolverConfig(**cfg_kw)),
                     JSolverConfig(**cfg_kw))
    ts = t_admm.admm(tp, t_fac, t_admm.init_state(tp, None),
                     SolverConfig(**cfg_kw))
    assert ts.k == int(js.k)
    assert float(ts.rho) == float(js.rho)
    assert ts.best_rel_gap <= 1e-9
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(ts.x_best.numpy(), np.asarray(js.x_best),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("l1", 0, 0.1),
    ("nonneg_l1", 0, 0.0),
    ("group_l2", 16, 0.0),
])
def test_admm_converges_and_matches_fista(kind, ngroups, lam2):
    # tests/test_admm.py:test_admm_converges_and_matches_fista's cases
    jp, tp = _pair(0, 96, 256, kind, ngroups, lam2)
    res = cot.solve(tp, "admm", tol=1e-5, max_iters=2000)
    ref = j_solve(jp, "fista", tol=1e-6, max_iters=5000)
    assert res.method == "admm" and res.converged, res.rel_gap
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=2.5e-3)
    # the returned iterate really certifies at the claimed gap
    assert float(j_gap(jp, jnp.asarray(res.x.numpy())).rel_gap) < 2e-5
    assert res.iterations == int(res.history["iteration"][-1])


def test_admm_overdetermined():
    # m > n: the direct Gram branch
    jp, tp = _pair(0, 256, 96)
    res = cot.solve(tp, "admm", tol=1e-5, max_iters=2000,
                    admm_setup="host")
    assert res.converged
    ref = j_solve(jp, "fista", tol=1e-6, max_iters=5000)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=2.5e-3)


def test_admm_robust_on_ill_conditioned():
    # tests/test_admm.py:test_admm_robust_on_ill_conditioned's instance
    key = jax.random.PRNGKey(3)
    m, n = 128, 96
    U = jnp.linalg.qr(jax.random.normal(key, (m, m)))[0]
    V = jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(4), (n, n)))[0]
    s = jnp.geomspace(1.0, 1e-3, n)
    A = ((U[:, :n] * s) @ V.T).astype(jnp.float32)
    b = A @ jnp.zeros((n,), jnp.float32).at[:8].set(1.0)
    from convex_optimization_tpu.core.objective import lambda_max

    lam = 0.05 * float(lambda_max(A, b, j_l1(1.0)))
    jp = j_make(A, b, lam)
    tp = problem_from_numpy(np.array(A), np.array(b), "l1", lam,
                            device="cpu")
    res = cot.solve(tp, "admm", tol=1e-4, max_iters=3000)
    assert res.converged
    ref = j_solve(jp, "fista", tol=1e-4, max_iters=5000)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=5e-3)


def test_admm_scale_fence_falls_back_with_warning(monkeypatch):
    # the fence dimension lowered, as the JAX package's test does
    monkeypatch.setattr(api, "ADMM_FENCE_DIM", 64)
    _, tp = _pair(9, 96, 384)
    with pytest.warns(UserWarning, match="admm_force"):
        res = cot.solve(tp, "admm", tol=1e-4, max_iters=1500)
    assert res.method == "fista"
    assert res.converged
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # no fence warning allowed
        forced = cot.solve(tp, "admm", tol=1e-4, max_iters=1500,
                           admm_force=True)
    assert forced.method == "admm"


def test_admm_host_setup_skips_fence(monkeypatch):
    monkeypatch.setattr(api, "ADMM_FENCE_DIM", 64)
    _, tp = _pair(19, 96, 384)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = cot.solve(tp, "admm", tol=1e-3, max_iters=400,
                        stall_checks=10, admm_setup="host")
    assert res.method == "admm"
    assert res.setup_time_s > 0.0


def test_admm_host_setup_matches_fista():
    # tests/test_admm.py:test_admm_host_setup_beats_device_setup's
    # instance: the host (f64 eigh) set-up certifies 1e-5 and agrees with
    # the JAX package's FISTA solution; set-ups other than 'device' and
    # 'host' are refused
    jp, tp = _pair(17, 96, 384)
    host = cot.solve(tp, "admm", tol=1e-5, max_iters=3000,
                     admm_setup="host")
    assert host.converged, host.rel_gap
    ref = j_solve(jp, "fista", tol=1e-5, max_iters=5000)
    np.testing.assert_allclose(host.x.numpy(), np.asarray(ref.x), atol=5e-4)
    with pytest.raises(ValueError, match="admm_setup"):
        cot.solve(tp, "admm", admm_setup="gpu")


def test_admm_path_matches_jax_paths():
    # tests/test_admm.py:test_admm_lambda_path_matches_fista_path's
    # instance: the port's ADMM path against the JAX package's ADMM and
    # FISTA paths (its 2.5e-3)
    jp, tp = _pair(51, 96, 384)
    kw = dict(tol=1e-6, max_iters=3000, gap_every=5, stall_checks=10)
    ref = j_lambda_path(jp, JSolverConfig(**kw), path_len=5)
    j_adm = j_lambda_path(jp, JSolverConfig(**kw), path_len=5,
                          method="admm")
    adm = cot.lambda_path(tp, SolverConfig(**kw), path_len=5, method="admm")
    assert adm.method_used == "admm" and adm.kept is None
    np.testing.assert_allclose(adm.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-5)
    np.testing.assert_allclose(adm.xs.numpy(), np.asarray(ref.xs),
                               atol=2.5e-3)
    np.testing.assert_allclose(adm.xs.numpy(), np.asarray(j_adm.xs),
                               atol=2.5e-3)
    assert adm.sweeps == int(adm.iters.sum())


def test_admm_path_fence(monkeypatch):
    # above the fence the path warns and runs the FISTA path, unless
    # admm_setup='host'
    monkeypatch.setattr(api, "ADMM_FENCE_DIM", 64)
    _, tp = _pair(51, 96, 384)
    cfg = SolverConfig(tol=1e-5, max_iters=3000, gap_every=5,
                       stall_checks=10)
    with pytest.warns(UserWarning, match="admm_setup='host'"):
        res = cot.lambda_path(tp, cfg, path_len=3, method="admm")
    assert res.method_used == "fista"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = cot.lambda_path(tp, cfg, path_len=3, method="admm",
                              admm_setup="host")
    assert res.method_used == "admm"


def test_admm_path_makes_no_torch_mv_over_A(monkeypatch):
    """Every pass over A in the loop goes through the K2/K3 wrappers:
    Problem.residual and dual_witness (torch.mv) are never called."""
    def no_mv(*a, **kw):
        raise AssertionError("a torch.mv over A on the ADMM path")

    _, tp = _pair(51, 96, 384)
    monkeypatch.setattr(Problem, "residual", no_mv)
    monkeypatch.setattr(t_objective, "dual_witness", no_mv)
    res = cot.solve(tp, "admm", tol=1e-5, max_iters=2000,
                    admm_setup="host")
    assert res.converged
