"""The port's ``polish``, ``polish_fast`` and ``_fista64``
(``solvers/polish.py``) against the JAX package's, on the same numpy
instances, from the same f32 solve's x:

  * ``_fista64`` on the same compact f64 arrays (l1, nonneg_l1 with lam2,
    weighted group_l2; with and without the re-screening cushion, with
    backtracking and with a given L): x, iterations and gaps to 1e-12;
  * ``polish`` and the host variant of ``polish_fast`` (``A_host``):
    certified <= tol, the same ``kept``, x within 1e-7;
  * the device variant of ``polish_fast`` (K3's plain version on the
    CPU): certified <= tol, x within 1e-7.  Its screen inflates K3's f32
    witness by K3's stated bound ``witness_gamma`` (exact f64 on the
    columns that could reach the dual norm) and scales theta0 feasible
    against it, with r and the gap in f64, where the JAX device variant
    works in f32 and scales theta0 by the f32 witness; so its kept set
    may differ from the JAX device variant's by a column at the sphere's
    boundary (at most 2 here), and keeps at least as many columns as the
    port host variant;
  * ``polish_support`` sends an unknown penalty kind to ``polish_fast``,
    as the JAX package does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.solvers import polish as JPol
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.solvers import polish as PPol

TOL = 1e-10
CASES = [("l1", 0, 0.0, False), ("nonneg_l1", 0, 1e-3, False),
         ("group_l2", 40, 0.0, True)]


def _instance(kind, ngroups, lam2, weighted):
    inst, A, b = make_lasso_instance_host(
        3, 150, 600, penalty_kind=kind, ngroups=ngroups, lam2=lam2,
        device="cpu")
    problem = inst.problem
    w = None
    if weighted:
        w = (0.5 + np.random.default_rng(1).random(ngroups)) \
            .astype(np.float32)
        problem = problem.with_penalty(cot.group_l2(
            float(problem.penalty.lam1), ngroups, torch.from_numpy(w)))
    jp = JProblem(A=jnp.asarray(A), b=jnp.asarray(b),
                  penalty=JPenalty(lam1=float(problem.penalty.lam1),
                                   kind=kind, ngroups=ngroups,
                                   weights=None if w is None
                                   else jnp.asarray(w)),
                  lam2=lam2)
    x = cot.solve(problem, "fista", tol=1e-4, max_iters=3000).x
    return problem, jp, A, b, x


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return _instance(*request.param)


@pytest.mark.parametrize("cushion", [0.0, 1e-3])
@pytest.mark.parametrize("given_L", [False, True])
def test_fista64_equals_jax(case, cushion, given_L):
    problem, _, A, b, x = case
    pen = problem.penalty
    idx = np.nonzero(np.abs(A.T @ b) > 0.2 * np.abs(A.T @ b).max())[0]
    if pen.kind == "group_l2":
        gs = problem.n // pen.ngroups
        groups = np.unique(idx // gs)
        idx = (groups[:, None] * gs + np.arange(gs)).reshape(-1)
        w = pen.weights.numpy()[groups]
        jpen = JPol._NpPenalty("group_l2", float(pen.lam1), len(groups), w,
                               len(idx))
        ppen = PPol._NpPenalty("group_l2", float(pen.lam1), len(groups), w)
    else:
        jpen = JPol._NpPenalty(pen.kind, float(pen.lam1), 0, None, len(idx))
        ppen = PPol._NpPenalty(pen.kind, float(pen.lam1))
    As = np.asfortranarray(A[:, idx], np.float64)
    b64 = b.astype(np.float64)
    xs = x.numpy().astype(np.float64)[idx]
    L = float(np.linalg.norm(As, 2) ** 2 + problem.lam2) if given_L else None
    args = (As, b64, problem.lam2)
    got = PPol._fista64(*args, ppen, xs, TOL, 3000, 4,
                        rescreen_cushion=cushion, L=L)
    want = JPol._fista64(*args, jpen, xs, TOL, 3000, 4,
                         rescreen_cushion=cushion, L=L)
    np.testing.assert_array_equal(got[1], want[1])        # keep_idx
    assert got[2] == want[2]                               # iterations
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    for g, w_ in zip(got[3:6], want[3:6]):                 # rel, gap, P
        assert abs(g - w_) <= 1e-12 * max(abs(w_), 1.0)
    assert got[3] <= TOL


@pytest.mark.parametrize("fn,host", [("polish", True),
                                     ("polish_fast", True),
                                     ("polish_fast", False)],
                         ids=["polish", "fast-host", "fast-device"])
def test_polish_equals_jax(case, fn, host):
    problem, jp, A, b, x = case
    kw = dict(A_host=A, b_host=b) if host else {}
    want = getattr(JPol, fn)(jp, jnp.asarray(x.numpy()), tol=TOL, **kw)
    got = getattr(PPol, fn)(problem, x, tol=TOL, **kw)
    assert got.rel_gap <= TOL and want.rel_gap <= TOL
    assert got.x.shape == (problem.n,) and got.x.dtype == np.float64
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got.x != 0, want.x != 0)
    if host:
        assert got.kept == want.kept
    else:
        host_kept = PPol.polish_fast(problem, x, tol=TOL, A_host=A,
                                     b_host=b).kept
        assert abs(got.kept - want.kept) <= 2 and got.kept >= host_kept
    # the certificate holds on the full problem in f64
    gap = cot.duality_gap(problem, torch.from_numpy(got.x), precise=True)
    assert float(gap.rel_gap) <= 10 * TOL


def test_polish_support_routes_unknown_kinds_to_polish_fast(monkeypatch):
    inst, A, b = make_lasso_instance_host(0, 32, 64, device="cpu")
    calls = []
    monkeypatch.setattr(PPol, "polish_fast",
                        lambda *a, **k: calls.append(k) or "fast")
    odd = inst.problem.with_penalty(
        cot.Penalty(lam1=inst.problem.penalty.lam1, kind="other"))
    assert PPol.polish_support(odd, inst.x_true, tol=1e-5, A_host=A,
                               b_host=b) == "fast"
    assert calls and calls[0]["tol"] == 1e-5 and calls[0]["A_host"] is A
