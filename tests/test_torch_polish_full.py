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
from tests.torch_threads import worker_threads  # noqa: F401

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


# ------------------------------------- the blocked CD of the card route ----

def _blocked_cd_model(As, b, lam2, kind, lam1, x0, sweeps, B):
    """NumPy model of K10's sweep (``csrc/cd64.cu``): per block of B
    consecutive columns, g = A_C^T r at the block's start, the block's
    coordinates in order with the in-block Gram correction, then r +=
    A_C d_C."""
    A = As.astype(np.float64)
    x = np.array(x0, np.float64)
    r = A @ x - b
    col_sq = (A * A).sum(axis=0) + lam2
    for _ in range(sweeps):
        for c0 in range(0, A.shape[1], B):
            C = slice(c0, min(c0 + B, A.shape[1]))
            A_C = A[:, C]
            g = A_C.T @ r
            G = A_C.T @ A_C
            d = np.zeros(A_C.shape[1])
            for i in range(A_C.shape[1]):
                j = c0 + i
                gi = g[i] + G[i, :i] @ d[:i] + lam2 * x[j]
                v = x[j] - gi / col_sq[j]
                tl = lam1 / col_sq[j]
                if kind == "nonneg_l1":
                    xn = max(v - tl, 0.0)
                else:
                    xn = np.sign(v) * max(abs(v) - tl, 0.0)
                d[i] = xn - x[j]
                x[j] = xn
            r += A_C @ d
    return x, r


def _support_case(kind, lam2, n=240, m=90, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    A = np.asfortranarray(A / np.linalg.norm(A, axis=0))
    xt = np.where(rng.random(n) < 0.15, rng.standard_normal(n), 0.0)
    if kind == "nonneg_l1":
        xt = np.abs(xt)
    b = A.astype(np.float64) @ xt + 0.01 * rng.standard_normal(m)
    atb = A.T.astype(np.float64) @ b
    lam1 = 0.1 * (atb.max() if kind == "nonneg_l1" else np.abs(atb).max())
    return A, b, float(lam1)


@pytest.mark.parametrize("B", [1, 7, 80])
@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_blocked_cd_model_equals_cyclic_cd64(kind, lam2, B):
    """The blocked update (g at the block's start plus the in-block Gram
    correction) is the cyclic CD: six sweeps of the model equal six sweeps
    of ``_cd64`` (no rescreen, no early stop) to 1e-12."""
    A, b, lam1 = _support_case(kind, lam2)
    x0 = np.zeros(A.shape[1])
    want = PPol._cd64(A, b, lam2, PPol._NpPenalty(kind, lam1), x0, 0.0, 6,
                      rescreen=False)
    x, r = _blocked_cd_model(A, b, lam2, kind, lam1, x0, 6, B)
    assert want[2] == 6
    np.testing.assert_allclose(x, want[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, want[6], rtol=0, atol=1e-12)


@pytest.mark.parametrize("B", [1, 7, 80])
@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_k10_plain_version_equals_the_model(kind, lam2, B):
    """K10's plain version (``ops/cd64.cd64_sweeps_t_plain``, what the
    kernel is held to on the card) on the zero-padded slab equals the
    NumPy model to 1e-12; the pad coordinates stay 0."""
    from convex_optimization_tpu_torch.ops import cd64

    A, b, lam1 = _support_case(kind, lam2)
    k = A.shape[1]
    slab = cd64.support_slab(torch.from_numpy(np.ascontiguousarray(A.T)),
                             torch.arange(k), B)
    gram = cd64.block_gram64(slab, B)
    col_sq = torch.diagonal(gram, dim1=1, dim2=2).reshape(-1) + lam2
    col_sq[k:] = 1.0
    x = torch.zeros(slab.shape[0], dtype=torch.float64)
    bt = torch.from_numpy(b)
    r = cd64.cd64_residual_t(slab, x, bt)
    cd64.cd64_sweeps_t(slab, x, r, col_sq, gram, lam1, lam2,
                       kind == "nonneg_l1", 4)
    want_x, want_r = _blocked_cd_model(A, b, lam2, kind, lam1, np.zeros(k),
                                       4, B)
    np.testing.assert_allclose(x[:k].numpy(), want_x, rtol=0, atol=1e-12)
    assert not x[k:].any()
    np.testing.assert_allclose(r.numpy(), want_r, rtol=0, atol=1e-12)


#: support cases of the card route's CD: (kind, lam2, support, B)
CARD_CASES = {
    "l1": ("l1", 0.0, "half", 16),
    "nonneg_l1": ("nonneg_l1", 1e-3, "half", 16),
    "ragged_k": ("l1", 0.0, "half", 48),          # k = 120, not a multiple
    "rescreen": ("nonneg_l1", 1e-3, "all", 32),   # drops columns mid-run
    "one_column": ("l1", 0.0, "one", 4),
}


@pytest.mark.parametrize("name", list(CARD_CASES))
def test_card_route_cd_equals_host_cd64(name):
    """``_cd64_card`` (the card route's CD: slab, Gram, K10's sweeps and
    the check's products, here by their plain versions on CPU tensors)
    against the host ``_cd64`` on the same columns: the same keep_idx and
    sweeps, x and r to 1e-10 relative."""
    kind, lam2, support, B = CARD_CASES[name]
    A, b, lam1 = _support_case(kind, lam2)
    n = A.shape[1]
    S = {"half": np.arange(0, n, 2), "all": np.arange(n),
         "one": np.array([int(np.argmax(np.abs(A.T @ b)))])}[support]
    pen = PPol._NpPenalty(kind, lam1)
    x0 = np.zeros(len(S))
    want = PPol._cd64(np.asfortranarray(A[:, S]), b, lam2, pen, x0, 1e-10,
                      4000)
    slab = PPol.support_slab(torch.from_numpy(np.ascontiguousarray(A.T)),
                             torch.from_numpy(S), B)
    got = PPol._cd64_card(slab, B, b, lam2, pen, x0, 1e-10, 4000)
    assert got[7] == "card" and want[7] in ("native", "numpy")
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] <= 1e-10
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got[6], want[6], rtol=0,
                               atol=1e-10 * float(np.abs(want[6]).max()))
    if name == "rescreen":
        assert len(got[1]) < len(S)


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_cd64_check_drops_by_the_gap_safe_sphere(kind, lam2):
    """The check both CD routes share: after 30 sweeps from 0 its keep
    is every column outside the gap-safe sphere's drop set, every nonzero
    x among them; None once rel_gap <= tol or without the rescreen."""
    A, b, lam1 = _support_case(kind, lam2)
    As = np.asfortranarray(A)
    pen = PPol._NpPenalty(kind, lam1)
    xs, _, _, _, _, _, r, _ = PPol._cd64(As, b, lam2, pen, np.zeros(
        A.shape[1]), 0.0, 30, rescreen=False)
    zs = PPol._gemv_t_mixed(As, r, lam2, xs)
    col_norms = np.sqrt((A.astype(np.float64) ** 2).sum(0) + lam2)
    gap, primal, rel, keep = PPol._cd64_check(r, b, lam2, pen, xs, zs,
                                              col_norms, 0.0, True)
    assert rel > 0.0 and keep is not None
    alpha = PPol._gap_from_parts(r, b, lam2, pen, xs, zs)[3]
    w = alpha * zs if kind == "nonneg_l1" else np.abs(alpha * zs)
    safe = w + np.sqrt(2.0 * gap) * col_norms < lam1
    np.testing.assert_array_equal(keep, np.nonzero(~(safe & (xs == 0)))[0])
    assert set(np.nonzero(xs)[0]) <= set(keep) and len(keep) < len(xs)
    for tol, rescreen in ((rel, True), (0.0, False)):
        out = PPol._cd64_check(r, b, lam2, pen, xs, zs, col_norms, tol,
                               rescreen)
        assert out[:3] == (gap, primal, rel) and out[3] is None


def test_card_plan_keeps_a_cpu_problem_on_the_host():
    import types

    assert PPol._card_plan(types.SimpleNamespace(
        device=torch.device("cpu"), m=700_000)) is None


def _cd64_routes(problem, x):
    from torch.profiler import ProfilerActivity, profile

    from convex_optimization_tpu_torch.utils import trace

    trace.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pr = cot.polish_support(problem, x, tol=1e-9)
    spans = [s for s in trace.RECORDER.records(trace.RECORDER.session)
             if s["name"] == "cot.polish.cd64"]
    trace.RECORDER.clear()
    return pr, spans


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_polish_support_cpu_problem_takes_the_host_route(kind, lam2):
    """A CPU problem's polish runs the host CD: its ``cot.polish.cd64``
    spans read route "native" ("numpy" without the library), the columns
    each round gathered and the sweeps."""
    from convex_optimization_tpu_torch.utils import native

    inst, A, b = make_lasso_instance_host(1, 120, 480, penalty_kind=kind,
                                          lam2=lam2, device="cpu")
    x = cot.solve(inst.problem, "fista", tol=1e-4, max_iters=3000).x
    pr, spans = _cd64_routes(inst.problem, x)
    assert pr.rel_gap <= 1e-9 and spans
    route = "native" if native.have_native() else "numpy"
    for s in spans:
        assert s["attrs"]["route"] == route
        assert s["attrs"]["sweeps"] > 0 and s["attrs"]["columns"] > 0


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_card_route_of_polish_support_equals_host_route(monkeypatch, kind,
                                                        lam2):
    """The card route of ``polish_support`` (the slab gathered from A's
    rows, ``_cd64_card``, the exact products of the witness and the near
    pass by K10's check, each by its plain version here), forced on a CPU
    problem, against the host route: the same kept columns and sweeps,
    gaps within 1e-12 of the primal, x within 1e-10; its spans read route
    "card"."""
    from convex_optimization_tpu_torch.ops.cd64 import Cd64Plan

    inst, A, b = make_lasso_instance_host(2, 150, 600, penalty_kind=kind,
                                          lam2=lam2, device="cpu")
    x = cot.solve(inst.problem, "fista", tol=1e-4, max_iters=3000).x
    host, _ = _cd64_routes(inst.problem, x)
    monkeypatch.setattr(PPol, "_card_plan",
                        lambda p: Cd64Plan(B=16, grid=1, rows=1, smem=0))
    card, spans = _cd64_routes(inst.problem, x)
    assert {s["attrs"]["route"] for s in spans} == {"card"}
    assert card.kept == host.kept and card.iterations == host.iterations
    assert card.rel_gap <= 1e-9 and host.rel_gap <= 1e-9
    assert abs(card.gap - host.gap) <= 1e-12 * abs(host.primal)
    np.testing.assert_allclose(card.x, host.x, rtol=0, atol=1e-10)
