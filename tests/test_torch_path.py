"""The batched lambda-path slice of the port — plain K5/K6/K7, lambda_max_t,
the sequential and batched lambda paths, K-fold CV — on the CPU against
the JAX package (its batch kernels in interpret mode) on the same numpy
arrays.

Tolerances and why:
  * plain K5 sweep: max|dX| <= 1e-5 max(1, ||X||_inf) and ||dR|| <= 1e-5
    ||R|| after one sweep, 1e-4 after five: the f32 sums run in another
    order, and Gauss-Seidel carries each block's rounding into the next;
  * the row-masked K5 equals K5 on a masked copy of A bit for bit
    (torch.equal): the 0/1 mask multiplies after the same f32 sums;
  * plain K6 / K7: 1e-5 relative to ||A||_F ||X|| (one f32 pass over A);
    lambda_max_t: rtol 1e-6 (one pass; the plain K3 sums in f64);
  * paths: a certificate pins the objective, not x, so the port's
    solutions are certified by the JAX package's own f64 gap (<= 2 tol)
    and compared by support (|x| > 1e-4); iteration counts are printed,
    not held equal (the cascade's f32 comparisons may tip differently);
  * CV: the fold masks are identical; validation MSE agrees to rtol 1e-3,
    the chosen indices exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu as co
from convex_optimization_tpu.core.datagen import (
    make_lasso_instance as j_make_instance,
    make_lasso_instance_host as j_make_host,
)
from convex_optimization_tpu.core.objective import (
    lambda_max_t as j_lambda_max_t,
)
from convex_optimization_tpu.ops.bcd_sweep_vpu_batch import (
    ax_minus_b_batch_t as j_ax_minus_b_batch_t,
    batch_sweep_vpu,
    neg_at_r_batch_t as j_neg_at_r_batch_t,
)
from convex_optimization_tpu.solvers.batched_path import (
    batched_lambda_path as j_batched_lambda_path,
)
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.cv import (
    cv_lambda_path as j_cv_lambda_path,
    kfold_train_masks as j_kfold_train_masks,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.core.objective import lambda_max_t
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    block_steps,
    sweep_t_plain,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    MAX_BATCH,
    ax_minus_b_batch_t,
    batch_sweep_t,
    eligible_batch,
    neg_at_r_batch_t,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.cv import kfold_train_masks
from tests.torch_threads import worker_threads  # noqa: F401

M, N, B = 64, 256, 32
NB = N // B


def _t(a):
    return torch.from_numpy(np.array(a))


def _arrays(seed, kind="l1", L=3):
    """A column-major (m, n) unit-norm A, b, an (n_blocks, L, B) X and the
    residual rows R consistent with it, all numpy f32."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M)).astype(np.float32).T
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.standard_normal(M).astype(np.float32)
    X = (0.1 * rng.standard_normal((NB, L, B))).astype(np.float32)
    if kind == "nonneg_l1":
        X = np.abs(X)
    R = np.stack([A @ X[:, l, :].reshape(N) - b for l in range(L)])
    return A, b, X, R.astype(np.float32), rng


def _A_t(A):
    return np.ascontiguousarray(A.T).reshape(NB, B, M)


@functools.lru_cache(maxsize=None)
def _j_sweep(kind, gsize):
    return jax.jit(functools.partial(batch_sweep_vpu, kind=kind, gsize=gsize,
                                     interpret=True))


def _close(Xt, Rt, Xj, Rj, tol):
    Xj, Rj = np.asarray(Xj), np.asarray(Rj)
    dx = np.abs(Xt.numpy() - Xj).max()
    assert dx <= tol * max(1.0, np.abs(Xj).max()), dx
    dr = np.linalg.norm(Rt.numpy() - Rj)
    assert dr <= tol * np.linalg.norm(Rj), dr


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("l1", 0, 1e-2),
    ("nonneg_l1", 0, 0.0),
    ("group_l2", 32, 0.0),
])
def test_batch_sweep_plain_matches_jax(kind, ngroups, lam2):
    A, b, X, R, rng = _arrays(11, kind)
    A_t = _A_t(A)
    gsize = N // ngroups if ngroups else 1
    w = rng.uniform(0.5, 2.0, ngroups).astype(np.float32) if ngroups \
        else None
    keep = rng.random(N) > 0.2
    steps = block_steps(block_power_t(_t(A_t)), lam2)
    lam1s = (np.array([2.0, 1.0, 0.25]) * 0.1
             * np.abs(A.T @ b).max()).astype(np.float32)
    pen = Penalty(lam1=1.0, kind=kind, ngroups=ngroups,
                  weights=None if w is None else _t(w))

    j_args = dict(weights=None if w is None else jnp.asarray(
        w.reshape(NB, 1, B // gsize)),
        mask=jnp.asarray(keep.astype(np.float32).reshape(NB, 1, B)))
    Xj, Rj = jnp.asarray(X), jnp.asarray(R)
    Xt, Rt = _t(X), _t(R)
    for sweep in range(1, 6):
        Xj, Rj = _j_sweep(kind, gsize)(
            jnp.asarray(A_t), Xj, Rj, jnp.asarray(steps.numpy()),
            jnp.asarray(lam1s), lam2, **j_args)
        Xt, Rt = batch_sweep_t(_t(A_t), Xt, Rt, steps, _t(lam1s), lam2, pen,
                               keep_mask=_t(keep))
        if sweep == 1:
            _close(Xt, Rt, Xj, Rj, 1e-5)
            # row l is the port's single-lambda sweep (plain K1) at lam1_l
            for l in range(3):
                x1, r1 = sweep_t_plain(
                    _t(A_t), _t(X[:, l, :].reshape(N)), _t(R[l]), steps,
                    _t(keep), pen.with_lam1(float(lam1s[l])), lam2)
                _close(Xt[:, l, :].reshape(N), Rt[l], x1.numpy(),
                       r1.numpy(), 1e-5)
    _close(Xt, Rt, Xj, Rj, 1e-4)
    assert bool((Xt.transpose(0, 1).reshape(3, N)[:, ~keep] == 0).all())


def test_masked_batch_sweep_is_exact_vs_masked_copy():
    A, b, X, _, rng = _arrays(12)
    A_t = _t(_A_t(A))
    rm = (rng.random(M) > 0.25).astype(np.float32)
    # residual rows consistent with X and masked (the invariant callers
    # hold)
    R = np.stack([rm * (A @ X[:, l, :].reshape(N) - b) for l in range(3)])
    steps = block_steps(block_power_t(A_t), 0.0)
    lam1s = _t(np.array([0.3, 0.1, 0.02], np.float32))
    pen = Penalty(lam1=1.0, kind="l1")
    X1, R1 = X2, R2 = _t(X), _t(R)
    for _ in range(3):
        X1, R1 = batch_sweep_t(A_t, X1, R1, steps, lam1s, 0.0, pen,
                               row_mask=_t(rm))
        X2, R2 = batch_sweep_t(A_t * _t(rm), X2, R2, steps, lam1s, 0.0, pen)
    assert torch.equal(X1, X2) and torch.equal(R1, R2)
    assert bool((R1[:, _t(rm) == 0] == 0).all())   # the invariant persists
    Xj, Rj = _j_sweep("l1", 1)(
        jnp.asarray(_A_t(A)), jnp.asarray(X), jnp.asarray(R),
        jnp.asarray(steps.numpy()), jnp.asarray(lam1s.numpy()), 0.0,
        row_mask=jnp.asarray(rm))
    X1, R1 = batch_sweep_t(A_t, _t(X), _t(R), steps, lam1s, 0.0, pen,
                           row_mask=_t(rm))
    _close(X1, R1, Xj, Rj, 1e-5)


@pytest.mark.parametrize("m", [M, M - 3])
@pytest.mark.parametrize("L", [1, 10, MAX_BATCH])
def test_batch_matvecs_plain_match_jax(L, m):
    """The plain K6/K7 (the card's oracles) against the JAX kernels at the
    smallest, the config-2 and the largest L the CUDA kernels cover, and
    at a ragged m (m % 4 != 0), where the CUDA kernels load A as scalars:
    the card tests (tests/test_torch_cuda.py) hold those instances to
    these oracles."""
    rng = np.random.default_rng(13)
    A = rng.standard_normal((N, m)).astype(np.float32).T
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    b = rng.standard_normal(m).astype(np.float32)
    A_t = np.ascontiguousarray(A.T).reshape(NB, B, m)
    X = rng.standard_normal((NB, L, B)).astype(np.float32)
    R = rng.standard_normal((L, m)).astype(np.float32)
    got = ax_minus_b_batch_t(_t(A_t), _t(X), _t(b)).numpy()
    want = np.asarray(j_ax_minus_b_batch_t(jnp.asarray(A_t), jnp.asarray(X),
                                           jnp.asarray(b), interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * np.linalg.norm(A) * \
        np.linalg.norm(X)
    got = neg_at_r_batch_t(_t(A_t), _t(R), _t(X), 0.37).numpy()
    want = np.asarray(j_neg_at_r_batch_t(jnp.asarray(A_t), jnp.asarray(R),
                                         jnp.asarray(X), 0.37,
                                         interpret=True))
    assert got.shape == (NB, L, B)
    assert np.abs(got - want).max() <= 1e-5 * np.linalg.norm(A) * \
        np.linalg.norm(R)


@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("nonneg_l1", 0),
                                          ("group_l2", 16)])
def test_lambda_max_t_matches_jax(kind, ngroups):
    A, b, _, _, _ = _arrays(14)
    A_t = _A_t(A)
    tp = problem_from_numpy(A, b, kind, 1.0, ngroups=ngroups, block=B,
                            device="cpu")
    got = float(lambda_max_t(tp.A_t, tp.b, tp.penalty))
    jp = co.Penalty(lam1=1.0, kind=kind, ngroups=ngroups)
    want = float(j_lambda_max_t(jnp.asarray(A_t), jnp.asarray(b), jp,
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_eligibility_gate():
    assert eligible_batch(64, 256, 32, 3)
    assert eligible_batch(64, 256, 32, MAX_BATCH)
    assert not eligible_batch(64, 256, 32, 0)
    assert not eligible_batch(64, 256, 32, MAX_BATCH + 1)
    assert not eligible_batch(64, 250, 32, 3)          # n % B
    assert not eligible_batch(64, 256, 20, 3)          # B % 8
    assert not eligible_batch(64, 256, 32, 3, dtype=torch.float64)


PATH_CFG = dict(tol=1e-5, max_iters=4000, gap_every=10, stall_checks=20)


def _weighted_pair(seed, kind, ngroups):
    """The JAX package's host instance and the port's problem on the same
    numpy arrays; group_l2 gets the same random weights in [0.5, 1.5) in
    both."""
    j_inst, A, b = j_make_host(seed, M, N, penalty_kind=kind,
                               ngroups=ngroups)
    jp = j_inst.problem
    w = None
    if kind == "group_l2":
        w = np.random.default_rng(seed).uniform(
            0.5, 1.5, ngroups).astype(np.float32)
        jp = dataclasses.replace(jp, penalty=dataclasses.replace(
            jp.penalty, weights=jnp.asarray(w)))
    tp = problem_from_numpy(A, b, kind, float(jp.penalty.lam1),
                            ngroups=ngroups, weights=w, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("nonneg_l1", 0),
                                          ("group_l2", 32)])
def test_batched_path_matches_jax(kind, ngroups):
    """The batched path against the JAX package's (its K5-K7 in interpret
    mode); group_l2 with weights runs K5's group prox."""
    jp, tp = _weighted_pair(21, kind, ngroups)
    j_res = j_batched_lambda_path(jp, JSolverConfig(**PATH_CFG), path_len=6)
    res = cot.batched_lambda_path(tp, SolverConfig(**PATH_CFG), path_len=6)
    print(f"{kind}: iters port {res.iters.tolist()} "
          f"jax {np.asarray(j_res.iters).tolist()}")
    assert res.method_used == j_res.method_used == "bcd_batch"
    np.testing.assert_allclose(res.lambdas.numpy(),
                               np.asarray(j_res.lambdas), rtol=1e-6)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(j_res.converged))
    for l, lam in enumerate(res.lambdas.tolist()):
        if not bool(res.converged[l]):
            continue
        gap = co.duality_gap(jp.with_lam1(lam),
                             jnp.asarray(res.xs[l].numpy()), precise=True)
        assert float(gap.rel_gap) <= 2 * PATH_CFG["tol"], (l, gap)
    np.testing.assert_array_equal(np.abs(res.xs.numpy()) > 1e-4,
                                  np.abs(np.asarray(j_res.xs)) > 1e-4)
    assert bool(res.converged.any())


@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("nonneg_l1", 0),
                                          ("group_l2", 32)])
def test_batched_path_matches_sequential(kind, ngroups):
    inst, _, _ = make_lasso_instance_host(22, M, N, penalty_kind=kind,
                                          ngroups=ngroups, device="cpu")
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    seq = cot.lambda_path(inst.problem, cfg, path_len=6, method="bcd_pallas")
    bat = cot.lambda_path(inst.problem, cfg, path_len=6, method="bcd_batch")
    assert (seq.method_used, bat.method_used) == ("bcd_pallas", "bcd_batch")
    torch.testing.assert_close(bat.lambdas, seq.lambdas, rtol=0, atol=0)
    # per-point certificate no worse than the sequential solver's own
    # (both floor at the instance's f32 noise on the deepest points)
    assert bool((bat.gaps <= torch.clamp(3.0 * seq.gaps, min=1e-5)).all())
    # a certificate pins the objective, not x: two certified solvers can
    # sit a few 1e-3 apart in x near lam_max (the JAX test's bound)
    torch.testing.assert_close(bat.xs, seq.xs, rtol=0, atol=5e-3)
    assert seq.sweeps == int(seq.iters.sum())
    assert bat.sweeps >= int(bat.iters.max())


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
def test_batched_path_certifies_converged_points_in_f64(seed):
    """A weighted group_l2 path at tol 1e-6, the f32 floor: every point
    the f32 monitor calls converged returns its f64 gap, at or under tol
    (a claim that fails in f64 is polished).  At seeds 0, 1 and 3 the f32
    reading alone returned points whose f64 gap passed 2 tol.
    certify=False keeps that rule on the same loop: the same sweeps and
    converged flags."""
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    w = np.random.default_rng(5).uniform(0.5, 1.5, 32).astype(np.float32)
    inst, _, _ = make_lasso_instance_host(seed, 128, 512,
                                          penalty_kind="group_l2",
                                          ngroups=32, device="cpu")
    p = inst.problem.with_penalty(dataclasses.replace(
        inst.problem.penalty, weights=torch.as_tensor(w)))
    res = cot.lambda_path(p, cfg, path_len=6, method="bcd_batch")
    raw = cot.batched_lambda_path(p, cfg, path_len=6, certify=False)
    assert res.method_used == raw.method_used == "bcd_batch"
    assert res.sweeps == raw.sweeps
    assert bool((res.converged == raw.converged).all())
    assert bool(res.converged.any())
    for l, lam in enumerate(res.lambdas.tolist()):
        if not bool(res.converged[l]):
            continue
        gap = float(cot.duality_gap(p.with_lam1(lam), res.xs[l],
                                    precise=True).rel_gap)
        assert gap <= cfg.tol, (l, gap)
        assert abs(float(res.gaps[l]) - gap) <= 1e-3 * gap + 1e-12, l


@pytest.mark.parametrize("readings,want", [
    ({0.0: 2e-6, 1.0: 1.5e-6, 2.0: 3e-6, 3.0: 8e-7}, (3.0, 8e-7)),
    ({0.0: 2e-6, 1.0: 1.9e-6, 2.0: 1.8e-6, 3.0: 1.7e-6, 4.0: 1e-7},
     (3.0, 1.7e-6))])
def test_confirm_polishes_a_failed_claim_again_from_its_rounded_x(
        readings, want):
    """A claim that fails in f64 is polished, then polished again from the
    last polish's output while its reading stays above tol, at most
    POLISH_TRIES times; the best reading and its x are kept.  A claim
    that holds, and a point that claims nothing, are left as they are.
    Point 1's f64 reading is looked up from its x; a polish adds 1."""
    from convex_optimization_tpu_torch.solvers import batched_path as bp

    assert bp.POLISH_TRIES == 3
    tol, L, m = 1e-6, 3, 4
    X = torch.zeros((1, L, 2))
    zeros = torch.zeros(L)
    state = bp._BatchState(
        X=X, R=torch.zeros((L, m)), X_best=X.clone(),
        R_best=torch.zeros((L, m)), best_gap=zeros,
        best_rel=torch.tensor([5e-7, 9e-7, 1e-5]), best_primal=zeros,
        iters_done=zeros, since_best=zeros, k=10)
    polished = []

    def exact_gap(X, sel):
        rel = torch.tensor([5e-7, readings[float(X[0, 1, 0])], 0.0],
                           dtype=torch.float64)
        rel = torch.where(sel, rel, torch.zeros_like(rel))
        R = torch.where(sel[:, None], X[0, :, :1].double().expand(L, m),
                        torch.zeros((L, m), dtype=torch.float64))
        return rel, 10 * rel, R

    def polish(lam, x):
        polished.append(float(x[0]))
        return x + 1.0

    out = bp._confirm(state, torch.tensor([3.0, 2.0, 1.0]), tol, exact_gap,
                      polish)
    assert polished == [0.0, 1.0, 2.0]
    x1, rel1 = want
    assert float(out.X_best[0, 1, 0]) == x1
    assert float(out.best_rel[1]) == pytest.approx(rel1)
    assert float(out.best_gap[1]) == pytest.approx(10 * rel1)
    assert bool((out.R_best[1] == x1).all())
    assert float(out.best_rel[0]) == pytest.approx(5e-7)
    assert float(out.best_rel[2]) == pytest.approx(1e-5)
    assert bool((out.X_best[:, [0, 2]] == 0).all())


def test_batched_path_dense_grid_chunks():
    """Grids past MAX_BATCH run in warm-started chunks and stay
    certified."""
    inst, _, _ = make_lasso_instance_host(23, M, N, device="cpu")
    L = MAX_BATCH + 5
    res = cot.batched_lambda_path(
        inst.problem, SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                                   stall_checks=20), path_len=L)
    assert res.method_used == "bcd_batch"
    assert res.xs.shape == (L, N)
    assert bool((res.gaps <= 1e-4).all())
    assert bool((res.lambdas[1:] < res.lambdas[:-1]).all())


def test_batched_path_falls_back_loudly_on_ineligible():
    # an f64 problem fails the gate: the sequential path runs, with a
    # warning naming the reason, and method_used records it
    inst, _, _ = make_lasso_instance_host(24, M, N, device="cpu")
    p = inst.problem
    p64 = dataclasses.replace(p, A_t=p.A_t.double(), b=p.b.double())
    cfg = SolverConfig(tol=1e-7, max_iters=4000)
    with pytest.warns(UserWarning, match="bcd_batch gate failed"):
        res = cot.batched_lambda_path(p64, cfg, path_len=4)
    assert res.method_used == "bcd_pallas"
    assert res.xs.shape == (4, N) and res.xs.dtype == torch.float64
    assert bool(res.converged.all())


def test_row_mask_path_equals_masked_copy_problem():
    inst, _, _ = make_lasso_instance_host(25, M, N, device="cpu")
    p = inst.problem
    rm = _t(kfold_train_masks(M, 4, seed=2)[1])
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    lmax = float(lambda_max_t(p.A_t, p.b * rm, p.penalty))
    grid = torch.as_tensor(np.geomspace(0.8 * lmax, 0.1 * lmax, 5),
                           dtype=torch.float32)
    masked = cot.batched_lambda_path(p, cfg, lambdas=grid, row_mask=rm)
    p_copy = dataclasses.replace(p, A_t=p.A_t * rm, b=p.b * rm)
    copy = cot.batched_lambda_path(p_copy, cfg, lambdas=grid)
    assert masked.method_used == "bcd_batch"
    assert bool((masked.gaps <= 1e-4).all())
    torch.testing.assert_close(masked.xs, copy.xs, rtol=0, atol=5e-3)


def test_bcd_batch_compact_raises():
    inst, _, _ = make_lasso_instance_host(26, 32, 64, device="cpu")
    with pytest.raises(ValueError, match="bcd_batch"):
        cot.lambda_path(inst.problem, SolverConfig(), path_len=3,
                        method="bcd_batch", compact=True)


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_path_options_raise(kw):
    """A mesh that is no group of ranks is refused by name (every layout
    of the JAX package is ported, so none raises NotImplementedError)."""
    inst, _, _ = make_lasso_instance_host(26, 32, 64, device="cpu")
    with pytest.raises(TypeError, match="ColumnGroup, RowGroup or GridGroup"):
        cot.lambda_path(inst.problem, SolverConfig(), path_len=3, **kw)
    with pytest.raises(ValueError):
        cot.lambda_path(inst.problem, SolverConfig(), method="nope")


def test_solve_bcd_batch_raises_value_error():
    inst, _, _ = make_lasso_instance_host(8, 32, 64, device="cpu")
    with pytest.raises(ValueError, match="lambda_path"):
        cot.solve(inst.problem, "bcd_batch")


def test_cv_matches_jax():
    # the JAX package's own CV route test instance (tests/test_cv.py),
    # handed to the port as numpy arrays
    jp = j_make_instance(jax.random.PRNGKey(33), 96, 320,
                         noise_std=0.05).problem
    tp = problem_from_numpy(np.array(jp.A), np.array(jp.b), "l1",
                            float(jp.penalty.lam1), device="cpu")
    kw = dict(tol=1e-6, max_iters=6000, gap_every=10, stall_checks=20)
    np.testing.assert_array_equal(kfold_train_masks(96, 3, seed=4),
                                  j_kfold_train_masks(96, 3, seed=4))
    j_res = j_cv_lambda_path(jp, JSolverConfig(**kw), k=3, path_len=6,
                             seed=4)
    res = cot.cv_lambda_path(tp, SolverConfig(**kw), k=3, path_len=6,
                             seed=4)
    copy = cot.cv_lambda_path(tp, SolverConfig(**kw), k=3, path_len=6,
                              seed=4, method="bcd")
    print(f"fold sweeps {res.fold_sweeps}")
    assert res.method_used == j_res.method_used == "bcd_batch"
    assert copy.method_used == "bcd"
    assert res.val_mse.shape == (3, 6)
    np.testing.assert_allclose(res.val_mse.numpy(),
                               np.asarray(j_res.val_mse), rtol=1e-3)
    assert res.best_index == j_res.best_index
    assert res.one_se_index == j_res.one_se_index
    # the kernel route and the masked-copy route: two certified solvers,
    # so x differs by ~1e-3 and a held-out MSE by ~1e-3 absolute
    np.testing.assert_allclose(res.val_mse.numpy(), copy.val_mse.numpy(),
                               rtol=1e-3, atol=2e-3)
    assert (res.best_index, res.one_se_index) == \
        (copy.best_index, copy.one_se_index)
    assert res.x.shape == (320,) and res.x_one_se.shape == (320,)


def test_batch_launch_counters_stay_zero_on_cpu():
    _build.reset_launches()
    inst, _, _ = make_lasso_instance_host(28, M, N, device="cpu")
    cot.cv_lambda_path(inst.problem, SolverConfig(tol=1e-4, max_iters=200),
                       k=2, path_len=3)
    assert sum(_build.launches.values()) == 0


def test_group_cv_matches_jax():
    """Weighted group_l2 CV through the batched kernels (K5's group prox
    with the fold row masks) against the JAX package's on the same
    arrays: the same fold masks, val_mse to rtol 1e-3, the same indices."""
    jp, tp = _weighted_pair(29, "group_l2", 32)
    kw = dict(tol=1e-5, max_iters=4000, gap_every=10, stall_checks=20)
    j_res = j_cv_lambda_path(jp, JSolverConfig(**kw), k=3, path_len=5,
                             seed=1)
    res = cot.cv_lambda_path(tp, SolverConfig(**kw), k=3, path_len=5,
                             seed=1)
    assert res.method_used == j_res.method_used == "bcd_batch"
    np.testing.assert_allclose(res.val_mse.numpy(),
                               np.asarray(j_res.val_mse), rtol=1e-3)
    assert (res.best_index, res.one_se_index) == \
        (j_res.best_index, j_res.one_se_index)
    assert res.x.shape == (N,)


def test_cv_without_refit_matches_jax():
    """refit=False skips the full-data path in both packages: the same
    val_mse (rtol 1e-3) and indices, and no x."""
    jp, tp = _weighted_pair(30, "l1", 0)
    kw = dict(tol=1e-5, max_iters=4000, gap_every=10, stall_checks=20)
    j_res = j_cv_lambda_path(jp, JSolverConfig(**kw), k=3, path_len=5,
                             seed=2, refit=False)
    res = cot.cv_lambda_path(tp, SolverConfig(**kw), k=3, path_len=5,
                             seed=2, refit=False)
    assert res.x is None and res.x_one_se is None
    assert j_res.x is None and j_res.x_one_se is None
    np.testing.assert_allclose(res.val_mse.numpy(),
                               np.asarray(j_res.val_mse), rtol=1e-3)
    assert (res.best_index, res.one_se_index) == \
        (j_res.best_index, j_res.one_se_index)
    assert len(res.fold_sweeps) == 3
