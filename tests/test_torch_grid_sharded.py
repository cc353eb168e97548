"""The port's grid-sharded solvers (``parallel/grid_sharded.py``) on 2 x 2
gloo ranks on the CPU (K2-K4 plain versions), against the JAX package's
grid-sharded solvers on ``make_grid_mesh(2, 2)`` over the conftest's CPU
devices, fed the same NumPy arrays.  Case by case as
``tests/test_grid_sharding.py``:

  * FISTA (l1; nonneg_l1 with lam2; weighted group_l2) and ISTA (l1) fed
    the same L_total: the primal at every matching check to rtol 1e-4,
    the final x to atol 5e-5;
  * the BCD (Gauss-Seidel within a column shard, the Jacobi merge across
    them) fed the same block_L: the primal to rtol 1e-4 at matching
    checks, x to atol 5e-4 (the merge's line search, as the column
    layout's BCD tolerance);
  * screening: x as FISTA's, the same screened columns but those whose
    margin at the JAX iterate is under 1e-4 relative;
  * ``solve(mesh=GridGroup)`` for fista, ista, bcd and bcd_pallas: the
    JAX method names and stop, x near the JAX ``solve``'s;
  * ``lambda_path(mesh=GridGroup)`` (fista, bcd_pallas) against JAX
    ``lambda_path(mesh=make_grid_mesh(2, 2))``, which runs the column
    path over the blocks axis;
  * the refusals (the JAX texts) and ``grid_group``'s device count.

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
from convex_optimization_tpu.parallel.grid_sharded import (
    _state_specs_grid,
    grid_sharded_bcd as j_grid_sharded_bcd,
    grid_sharded_fista as j_grid_sharded_fista,
    make_grid_mesh,
)
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.fista import init_state as j_init_state
from convex_optimization_tpu.solvers.lambda_path import (
    lambda_path as j_lambda_path,
)
from convex_optimization_tpu.parallel.mesh import BLOCKS, ROWS
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.parallel.mesh import (
    ColumnGroup,
    GridGroup,
    Group,
    RowGroup,
    check_grid_size,
)
from test_torch_row_sharded import _instance, _pens
from test_torch_rowgrid_ranks import run_layout
from test_torch_sharded_path import _jax_problem, _raised, _screen_margin

R = C = 2
M, N, BLOCK = 128, 256, 32
FISTA = dict(tol=1e-5, max_iters=2000, gap_every=10)
ISTA = dict(tol=1e-5, max_iters=300, gap_every=10, momentum=False)
BCD = dict(tol=1e-5, max_iters=600, gap_every=5, block_size=BLOCK,
           stall_checks=10)
SCREEN = dict(FISTA, screen_every=1)
PATH = dict(tol=1e-6, max_iters=2000, gap_every=10, block_size=16,
            stall_checks=10)
X_ATOL = {"fista": 5e-5, "bcd": 5e-4}
H_RTOL, MARGIN = 1e-4, 1e-4
KINDS = ("l1", "nonneg_l1", "group_l2")


@pytest.fixture(scope="module")
def data():
    A, b, lam1 = _instance(44, M, N)
    pens = _pens(A, b, lam1)
    p = cot.problem_from_numpy(A, b, device="cpu", **pens["l1"])
    As, bs, ls = _instance(45, M, 512)
    Ap, bp, lp = _instance(23, 96, 128)
    return dict(
        main=(A, b), pens=pens, L_A=float(np.linalg.norm(A, 2) ** 2 * 1.02),
        block_L=block_power_t(p.with_block(BLOCK).A_t).numpy(),
        screen=(As, bs), screen_pen=dict(penalty_kind="l1", lam1=ls),
        screen_L=float(np.linalg.norm(As, 2) ** 2 * 1.02),
        path=(Ap, bp), path_pen=dict(penalty_kind="l1", lam1=lp))


def _runs(d):
    """(name, instance, run) of every rank-side run."""
    runs = []
    for kind in KINDS:
        pen = d["pens"][kind]
        runs.append((("fista", kind), "main", dict(
            kind="fed", method="fista", pen=pen, cfg=FISTA,
            L_total=d["L_A"] + pen.get("lam2", 0.0))))
        runs.append((("bcd", kind), "main", dict(
            kind="fed", method="bcd", pen=pen, cfg=BCD,
            block_L=d["block_L"], block=BLOCK)))
    runs.append((("ista", "l1"), "main", dict(
        kind="fed", method="fista", pen=d["pens"]["l1"], cfg=ISTA,
        L_total=d["L_A"])))
    for method, cfg in (("fista", FISTA), ("ista", ISTA), ("bcd", BCD),
                        ("bcd_pallas", BCD)):
        runs.append((("api", method), "main", dict(
            kind="api", method=method, pen=d["pens"]["l1"], cfg=cfg)))
    scr = d["screen_pen"]
    runs.append((("screen", "fed"), "screen", dict(
        kind="fed", method="fista", pen=scr, cfg=SCREEN,
        L_total=d["screen_L"])))
    runs.append((("screen", "api"), "screen", dict(
        kind="api", method="fista", pen=scr, cfg=SCREEN)))
    for method in ("fista", "bcd_pallas"):
        runs.append((("path", method), "path", dict(
            kind="path", pen=d["path_pen"], cfg=PATH,
            kw=dict(path_len=4, method=method))))
    return runs


_cache: dict = {}


def _ranks(d, tmp_path_factory):
    """Every rank-side run in one launch of R x C ranks."""
    if "grid" not in _cache:
        runs = _runs(d)
        jobs = [(d[inst], [run]) for _, inst, run in runs]
        got = run_layout(("grid", R, C), R * C,
                         tmp_path_factory.mktemp("grid"), jobs)
        _cache["grid"] = dict(zip([n for n, _, _ in runs], got))
    return _cache["grid"]


def _jax_grid(A, b, pen, run):
    """The JAX grid-sharded solver of ``run`` on make_grid_mesh(R, C), fed
    its L_total or block_L, placed as ``_solve_grid_sharded`` places it."""
    jp = _jax_problem(A, b, pen)
    mesh = make_grid_mesh(R, C)
    ps = dataclasses.replace(
        jp, A=jax.device_put(jp.A, NamedSharding(mesh, PS(ROWS, BLOCKS))),
        b=jax.device_put(jp.b, NamedSharding(mesh, PS(ROWS))))
    cfg = JSolverConfig(**{k: v for k, v in run["cfg"].items()
                           if k != "block_size"})
    state = jax.device_put(
        j_init_state(ps, None, cfg),
        jax.tree.map(lambda sp: NamedSharding(mesh, sp), _state_specs_grid(),
                     is_leaf=lambda v: isinstance(v, PS)))
    if run["method"] == "fista":
        fn, args = j_grid_sharded_fista(
            ps, jnp.asarray(run["L_total"], jnp.float32), state, cfg, mesh)
    else:
        fn, args = j_grid_sharded_bcd(ps, jnp.asarray(run["block_L"]),
                                      state, cfg, mesh)
    return fn(*args)


def _check_fed(got, final, method, tol):
    hj = final.history.trimmed()
    k = min(len(hj["primal"]), len(got["history"]["primal"]))
    assert k >= 2
    np.testing.assert_allclose(got["history"]["primal"][:k],
                               hj["primal"][:k], rtol=H_RTOL)
    np.testing.assert_allclose(got["x"], np.asarray(final.x_best),
                               atol=X_ATOL[method])
    assert got["converged"] == bool(final.best_rel_gap <= tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["fista", "bcd"])
def test_grid_sharded_matches_jax(data, tmp_path_factory, method, kind):
    got = _ranks(data, tmp_path_factory)[(method, kind)]
    assert sum(got["launches"].values()) == 0              # plain versions
    run = dict((n, r) for n, _, r in _runs(data))[(method, kind)]
    final = _jax_grid(*data["main"], run["pen"], run)
    _check_fed(got, final, method, run["cfg"]["tol"])
    assert got["converged"]
    if kind == "nonneg_l1":
        assert (got["x"] >= 0).all()


def test_grid_sharded_ista_matches_jax(data, tmp_path_factory):
    got = _ranks(data, tmp_path_factory)[("ista", "l1")]
    run = dict((n, r) for n, _, r in _runs(data))[("ista", "l1")]
    _check_fed(got, _jax_grid(*data["main"], run["pen"], run), "fista",
               ISTA["tol"])


@pytest.mark.parametrize("method", ["fista", "ista", "bcd", "bcd_pallas"])
def test_grid_sharded_solve_names_and_converges(data, tmp_path_factory,
                                                method):
    got = _ranks(data, tmp_path_factory)[("api", method)]
    name = {"bcd_pallas": "bcd"}.get(method, method)
    assert got["method"] == f"grid_sharded_{name}"
    cfg = ISTA if method == "ista" else BCD if "bcd" in method else FISTA
    jp = _jax_problem(*data["main"], data["pens"]["l1"])
    want = j_solve(jp, method, mesh=make_grid_mesh(R, C), **cfg)
    assert want.method == got["method"]
    assert got["converged"] == want.converged
    atol = X_ATOL["bcd" if "bcd" in method else "fista"]
    np.testing.assert_allclose(got["x"], np.asarray(want.x),
                               atol=atol if want.converged else 1e-3)


def test_grid_sharded_screening(data, tmp_path_factory):
    out = _ranks(data, tmp_path_factory)
    run = dict((n, r) for n, _, r in _runs(data))[("screen", "fed")]
    A, b = data["screen"]
    final = _jax_grid(A, b, run["pen"], run)
    got = out[("screen", "fed")]
    _check_fed(got, final, "fista", SCREEN["tol"])
    keep_j = np.asarray(final.keep_mask)
    assert (~keep_j).sum() > 0, "the JAX run screened nothing"
    differ = np.nonzero(keep_j != got["keep"])[0]
    margin = _screen_margin(A, b, run["pen"], np.asarray(final.x))
    assert (margin[differ] < MARGIN).all(), (differ, margin[differ])
    api = out[("screen", "api")]
    assert api["converged"] and 0 < api["screened"] < A.shape[1]


@pytest.mark.parametrize("method", ["fista", "bcd_pallas"])
def test_grid_lambda_path_is_the_column_path(data, tmp_path_factory,
                                             method):
    got = _ranks(data, tmp_path_factory)[("path", method)]
    jp = _jax_problem(*data["path"], data["path_pen"])
    want = j_lambda_path(jp, JSolverConfig(**PATH), path_len=4,
                         mesh=make_grid_mesh(R, C), method=method)
    assert got["method_used"] == want.method_used == f"{method}+sharded"
    np.testing.assert_allclose(got["lambdas"], np.asarray(want.lambdas),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got["xs"], np.asarray(want.xs),
        atol=X_ATOL["fista" if method == "fista" else "bcd"])
    gj = np.asarray(want.gaps)
    ok = ((got["gaps"] <= PATH["tol"]) & (gj <= PATH["tol"])) \
        | (got["gaps"] <= np.maximum(1e-5, 3.0 * gj))
    assert ok.all(), (got["gaps"], gj)


def _group():
    """A 2 x 2 GridGroup no rank joined: the refusals raise before any
    collective."""
    cpu = torch.device("cpu")
    return GridGroup(
        rows=RowGroup(None, 0, R, "gloo", cpu, (0, 2)),
        blocks=ColumnGroup(None, 0, C, "gloo", cpu, (0, 1)),
        world=Group(None, 0, R * C, "gloo", cpu, (0, 1, 2, 3)))


@pytest.mark.parametrize("m,n,pen,method", [
    (101, 64, "l1", "fista"),
    (128, 64, "group_l2", "bcd"),
    (128, 64, "l1", "fista_ws"),
])
def test_grid_sharded_refusals_match_jax(m, n, pen, method):
    A, b, lam1 = _instance(46, m, n)
    kw = dict(penalty_kind=pen, lam1=lam1)
    if pen == "group_l2":
        kw["ngroups"] = 1
    p = cot.problem_from_numpy(A, b, device="cpu", **kw)
    got = _raised(lambda: cot.solve(p, method, mesh=_group()))
    want = _raised(lambda: j_solve(_jax_problem(A, b, kw), method,
                                   mesh=make_grid_mesh(R, C)))
    assert got is not None and got == want


@pytest.mark.parametrize("rows,cols", [(2, 5), (3, 3)])
def test_grid_group_counts_the_ranks_as_jax(rows, cols):
    """Too few ranks for the grid: JAX ``make_grid_mesh``'s text over the
    conftest's 8 devices."""
    got = _raised(lambda: check_grid_size(rows, cols, len(jax.devices())))
    want = _raised(lambda: make_grid_mesh(rows, cols))
    assert got is not None and got == want
    with pytest.raises(ValueError, match="spans 4 ranks"):
        check_grid_size(2, 2, 5)
