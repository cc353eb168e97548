"""The port's row-sharded solvers (``parallel/row_sharded.py``) on P = 2
gloo ranks on the CPU (K2-K4 plain versions), against the JAX package's
row-sharded solvers on ``make_mesh(2, axis=ROWS)`` over the conftest's
CPU devices, fed the same NumPy arrays.  Case by case as
``tests/test_row_sharding.py``:

  * FISTA (l1; nonneg_l1 with lam2; weighted group_l2) and ISTA (l1) fed
    the same L_total as the JAX row FISTA: the primal at every matching
    check to rtol 1e-4, the final x to atol 5e-5;
  * the Gauss-Seidel BCD (l1; nonneg_l1 with lam2; weighted group_l2)
    fed the same block_L: as FISTA (the row BCD is the one-device sweep's
    arithmetic, so x to atol 5e-5 too);
  * the tall problem (m >> n) at tol 1e-6, fed and through ``solve``;
  * screening: x as above, and the same screened columns at the last
    check, except columns whose screen margin at the JAX iterate is under
    1e-4 relative;
  * ``solve(mesh=RowGroup)`` for fista, ista, bcd and bcd_pallas: the JAX
    method names, converged, x within 5e-5 of the fed runs' JAX x;
  * the row lambda path (fista, bcd) against JAX ``lambda_path(mesh=)``
    point by point;
  * the refusals: an m the ranks cannot split, a method the layout does
    not run (the JAX texts), and bcd_batch (column-only here; JAX raises a
    KeyError).

The ranks are spawned once for the module and the tests read the cached
results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from convex_optimization_tpu.api import solve as j_solve
from convex_optimization_tpu.parallel.mesh import ROWS, make_mesh
from convex_optimization_tpu.parallel.row_sharded import (
    _state_specs_rows,
    sharded_bcd_rows as j_sharded_bcd_rows,
    sharded_fista_rows as j_sharded_fista_rows,
)
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.fista import init_state as j_init_state
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.parallel.mesh import RowGroup
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from test_torch_rowgrid_ranks import run_layout
from test_torch_sharded_path import _jax_problem, _raised, _screen_margin

P = 2
M, N, BLOCK, NGROUPS, LAM2 = 128, 256, 32, 16, 1e-2
FISTA = dict(tol=1e-5, max_iters=2000, gap_every=10)
ISTA = dict(tol=1e-5, max_iters=300, gap_every=10, momentum=False)
BCD = dict(tol=1e-5, max_iters=600, gap_every=5, block_size=BLOCK)
TALL = dict(tol=1e-6, max_iters=3000, gap_every=10)
SCREEN = dict(FISTA, screen_every=1)
PATH = dict(tol=1e-5, max_iters=2000, gap_every=10, block_size=16,
            stall_checks=10)
X_ATOL, H_RTOL, MARGIN = 5e-5, 1e-4, 1e-4
KINDS = ("l1", "nonneg_l1", "group_l2")


def _pens(A, b, lam1):
    """problem_from_numpy's penalty arguments of the three kinds (the
    group lasso weighted, 16 groups: two per BCD block)."""
    w = np.random.default_rng(5).uniform(0.5, 1.5, NGROUPS).astype(
        np.float32)
    g_norms = np.linalg.norm((A.T @ b).reshape(NGROUPS, -1), axis=1)
    return {
        "l1": dict(penalty_kind="l1", lam1=lam1),
        "nonneg_l1": dict(penalty_kind="nonneg_l1",
                          lam1=float(0.1 * (A.T @ b).max()), lam2=LAM2),
        "group_l2": dict(penalty_kind="group_l2", ngroups=NGROUPS,
                         weights=w, lam1=float(0.3 * (g_norms / w).max())),
    }


def _instance(seed, m, n):
    inst, A, b = make_lasso_instance_host(seed, m, n, device="cpu")
    return A, b, float(inst.problem.penalty.lam1)


@pytest.fixture(scope="module")
def data():
    A, b, lam1 = _instance(33, M, N)
    pens = _pens(A, b, lam1)
    L_A = float(np.linalg.norm(A, 2) ** 2 * 1.02)
    p = cot.problem_from_numpy(A, b, device="cpu", **pens["l1"])
    block_L = block_power_t(p.with_block(BLOCK).A_t).numpy()
    At, bt, lt = _instance(4, 1024, 64)
    As, bs, ls = _instance(6, M, 512)
    Ap, bp, lp = _instance(23, 96, 128)
    return dict(
        main=(A, b), pens=pens, L_A=L_A, block_L=block_L,
        tall=(At, bt), tall_pen=dict(penalty_kind="l1", lam1=lt),
        tall_L=float(np.linalg.norm(At, 2) ** 2 * 1.02),
        screen=(As, bs), screen_pen=dict(penalty_kind="l1", lam1=ls),
        screen_L=float(np.linalg.norm(As, 2) ** 2 * 1.02),
        path=(Ap, bp), path_pen=dict(penalty_kind="l1", lam1=lp))


def _main_runs(d):
    """(name, run) on the main instance: the fed solvers, then solve()."""
    runs = []
    for kind in KINDS:
        pen = d["pens"][kind]
        runs.append((("fista", kind), dict(
            kind="fed", method="fista", pen=pen, cfg=FISTA,
            L_total=d["L_A"] + pen.get("lam2", 0.0))))
        runs.append((("bcd", kind), dict(
            kind="fed", method="bcd", pen=pen, cfg=BCD,
            block_L=d["block_L"], block=BLOCK)))
    runs.append((("ista", "l1"), dict(
        kind="fed", method="fista", pen=d["pens"]["l1"], cfg=ISTA,
        L_total=d["L_A"])))
    for method, cfg in (("fista", FISTA), ("ista", ISTA), ("bcd", BCD),
                        ("bcd_pallas", BCD)):
        runs.append((("api", method), dict(kind="api", method=method,
                                           pen=d["pens"]["l1"], cfg=cfg)))
    return runs


def _other_runs(d):
    """(name, instance, run) on the tall, screening and path instances."""
    tall, scr, path = d["tall_pen"], d["screen_pen"], d["path_pen"]
    return [
        (("tall", "fed"), "tall", dict(kind="fed", method="fista", pen=tall,
                                       cfg=TALL, L_total=d["tall_L"])),
        (("tall", "api"), "tall", dict(kind="api", method="fista", pen=tall,
                                       cfg=TALL)),
        (("screen", "fed"), "screen", dict(kind="fed", method="fista",
                                           pen=scr, cfg=SCREEN,
                                           L_total=d["screen_L"])),
        (("screen", "api"), "screen", dict(kind="api", method="fista",
                                           pen=scr, cfg=SCREEN)),
        (("path", "fista"), "path", dict(kind="path", pen=path, cfg=PATH,
                                         kw=dict(path_len=4))),
        (("path", "bcd"), "path", dict(kind="path", pen=path, cfg=PATH,
                                       kw=dict(path_len=4, method="bcd"))),
    ]


_cache: dict = {}


def _ranks(d, tmp_path_factory):
    """Every rank-side run in one launch of P ranks: the main instance's
    runs, then each other run on its own instance."""
    if "rows" not in _cache:
        main = _main_runs(d)
        other = _other_runs(d)
        jobs = [(d["main"], [r for _, r in main])] + [
            (d[inst], [run]) for _, inst, run in other]
        got = run_layout(("rows",), P, tmp_path_factory.mktemp("rows"),
                         jobs)
        names = [n for n, _ in main] + [n for n, _, _ in other]
        out = dict(zip(names, got))
        _cache["rows"] = out
    return _cache["rows"]


def _jax_rows(A, b, pen, run):
    """The JAX row-sharded solver of ``run`` on make_mesh(P, ROWS), fed
    its L_total or block_L, placed as ``_solve_row_sharded`` places it."""
    jp = _jax_problem(A, b, pen)
    mesh = make_mesh(P, axis=ROWS)
    ps = dataclasses.replace(
        jp, A=jax.device_put(jp.A, NamedSharding(mesh, PS(ROWS, None))),
        b=jax.device_put(jp.b, NamedSharding(mesh, PS(ROWS))))
    cfg = JSolverConfig(**{k: v for k, v in run["cfg"].items()
                           if k != "block_size"})
    state = jax.device_put(
        j_init_state(ps, None, cfg),
        jax.tree.map(lambda sp: NamedSharding(mesh, sp), _state_specs_rows(),
                     is_leaf=lambda v: isinstance(v, PS)))
    if run["method"] == "fista":
        fn, args = j_sharded_fista_rows(
            ps, jnp.asarray(run["L_total"], jnp.float32), state, cfg, mesh)
    else:
        fn, args = j_sharded_bcd_rows(ps, jnp.asarray(run["block_L"]),
                                      state, cfg, mesh)
    return fn(*args)


def _check_fed(got, final, tol):
    """The primal at every matching check to H_RTOL, x to X_ATOL."""
    hj = final.history.trimmed()
    k = min(len(hj["primal"]), len(got["history"]["primal"]))
    assert k >= 2
    np.testing.assert_allclose(got["history"]["primal"][:k],
                               hj["primal"][:k], rtol=H_RTOL)
    np.testing.assert_allclose(got["x"], np.asarray(final.x_best),
                               atol=X_ATOL)
    assert got["converged"] == bool(final.best_rel_gap <= tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["fista", "bcd"])
def test_row_sharded_matches_jax(data, tmp_path_factory, method, kind):
    got = _ranks(data, tmp_path_factory)[(method, kind)]
    assert sum(got["launches"].values()) == 0              # plain versions
    run = dict(_main_runs(data))[(method, kind)]
    final = _jax_rows(*data["main"], run["pen"], run)
    _check_fed(got, final, run["cfg"]["tol"])
    assert got["converged"]
    if kind == "nonneg_l1":
        assert (got["x"] >= 0).all()


def test_row_sharded_ista_matches_jax(data, tmp_path_factory):
    got = _ranks(data, tmp_path_factory)[("ista", "l1")]
    run = dict(_main_runs(data))[("ista", "l1")]
    _check_fed(got, _jax_rows(*data["main"], run["pen"], run), ISTA["tol"])


@pytest.mark.parametrize("method", ["fista", "ista", "bcd", "bcd_pallas"])
def test_row_sharded_solve_names_and_converges(data, tmp_path_factory,
                                               method):
    """``solve(mesh=RowGroup)``: the JAX method name, the same stop as the
    JAX ``solve`` on the row mesh, x near the fed runs' JAX x."""
    got = _ranks(data, tmp_path_factory)[("api", method)]
    name = {"bcd_pallas": "bcd"}.get(method, method)
    assert got["method"] == f"row_sharded_{name}"
    cfg = ISTA if method == "ista" else BCD if "bcd" in method else FISTA
    jp = _jax_problem(*data["main"], data["pens"]["l1"])
    want = j_solve(jp, method, mesh=make_mesh(P, axis=ROWS), **cfg)
    assert want.method == got["method"]
    assert got["converged"] == want.converged
    np.testing.assert_allclose(got["x"], np.asarray(want.x),
                               atol=X_ATOL if want.converged else 1e-3)


def test_row_sharded_tall_problem(data, tmp_path_factory):
    """The layout's regime, m >> n, at tol 1e-6: fed as the JAX solver,
    and through ``solve``."""
    out = _ranks(data, tmp_path_factory)
    run = dict((n, r) for n, _, r in _other_runs(data))[("tall", "fed")]
    final = _jax_rows(*data["tall"], run["pen"], run)
    _check_fed(out[("tall", "fed")], final, TALL["tol"])
    api = out[("tall", "api")]
    assert api["converged"] and api["method"] == "row_sharded_fista"
    np.testing.assert_allclose(api["x"], out[("tall", "fed")]["x"],
                               atol=X_ATOL)


def test_row_sharded_screening(data, tmp_path_factory):
    out = _ranks(data, tmp_path_factory)
    run = dict((n, r) for n, _, r in _other_runs(data))[("screen", "fed")]
    A, b = data["screen"]
    final = _jax_rows(A, b, run["pen"], run)
    got = out[("screen", "fed")]
    _check_fed(got, final, SCREEN["tol"])
    keep_j = np.asarray(final.keep_mask)
    assert (~keep_j).sum() > 0, "the JAX run screened nothing"
    differ = np.nonzero(keep_j != got["keep"])[0]
    margin = _screen_margin(A, b, run["pen"], np.asarray(final.x))
    assert (margin[differ] < MARGIN).all(), (differ, margin[differ])
    api = out[("screen", "api")]
    assert api["converged"] and 0 < api["screened"] < A.shape[1]


@pytest.mark.parametrize("method", ["fista", "bcd"])
def test_row_sharded_lambda_path(data, tmp_path_factory, method):
    got = _ranks(data, tmp_path_factory)[("path", method)]
    assert got["method_used"] == f"{method}+sharded"
    jp = _jax_problem(*data["path"], data["path_pen"])
    want = j_lambda_path(jp, JSolverConfig(**PATH), path_len=4,
                         mesh=make_mesh(P, axis=ROWS), method=method)
    assert want.method_used == got["method_used"]
    np.testing.assert_allclose(got["lambdas"], np.asarray(want.lambdas),
                               rtol=1e-5)
    np.testing.assert_allclose(got["xs"], np.asarray(want.xs), atol=X_ATOL)
    gj = np.asarray(want.gaps)
    ok = ((got["gaps"] <= PATH["tol"]) & (gj <= PATH["tol"])) \
        | (got["gaps"] <= np.maximum(1e-5, 3.0 * gj))
    assert ok.all(), (got["gaps"], gj)


def _group(size=P):
    """A RowGroup no rank joined: the refusals raise before any
    collective."""
    return RowGroup(group=None, rank=0, size=size, backend="gloo",
                    device=torch.device("cpu"), global_ranks=(0, 1))


@pytest.mark.parametrize("m,method", [(101, "fista"), (128, "fista_ws")])
def test_row_sharded_refusals_match_jax(m, method):
    A, b, lam1 = _instance(5, m, 64)
    pen = dict(penalty_kind="l1", lam1=lam1)
    p = cot.problem_from_numpy(A, b, device="cpu", **pen)
    got = _raised(lambda: cot.solve(p, method, mesh=_group()))
    want = _raised(lambda: j_solve(_jax_problem(A, b, pen), method,
                                   mesh=make_mesh(P, axis=ROWS)))
    assert got is not None and got == want


def test_row_sharded_bcd_batch_refuses():
    A, b, lam1 = _instance(5, 128, 64)
    p = cot.problem_from_numpy(A, b, device="cpu", penalty_kind="l1",
                               lam1=lam1)
    with pytest.raises(ValueError, match="column slabs only"):
        cot.lambda_path(p, SolverConfig(), path_len=3, mesh=_group(),
                        method="bcd_batch")
