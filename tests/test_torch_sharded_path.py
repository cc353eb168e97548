"""Gap-safe screening in the port's column-sharded solvers and the sharded
lambda paths, on P = 2 gloo ranks on the CPU (one case at P = 4; K2-K8
plain versions), against the JAX package on a mesh of the same P
(``make_mesh(P)`` over the conftest's CPU devices), fed the same NumPy
arrays.

  * Screened sharded FISTA and BCD (l1, nonneg_l1 with lam2, weighted
    group_l2; psum, and the ring for one case) fed the same L_total /
    block_L as the JAX sharded solvers: the final x to
    ``test_torch_sharded.py``'s tolerances (atol 5e-5 FISTA, 5e-4 BCD),
    and the same screened columns at the last check, except columns whose
    screen margin at the JAX iterate is under 1e-4 relative (named by the
    failure message).
  * The sequential sharded paths (``lambda_path(mesh=)``, fista and
    bcd_pallas; l1 and group_l2): the grid to rtol 1e-5, per-point x to
    the same tolerances, both gaps <= tol or the port's <= max(1e-5, 3x
    the JAX gap), the same ``method_used``.
  * The batched sharded path (bcd_batch; l1 and group_l2; a grid of
    MAX_BATCH + 2 points; a row mask): xs atol 1e-3 against the JAX
    sharded path, gaps as above (the JAX package's own sharded batched
    tests, ``tests/test_batched_path.py:305-366``, run its kernels in
    interpret mode here); blocks that do not divide over the ranks warn
    "bcd_batch gate failed" and run "bcd_pallas+sharded", as in JAX.
  * The refusals of an unknown method and of ``compact=True`` with a
    mesh, with the JAX texts.

The ranks are spawned once per P for the module and the tests read the
cached results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.parallel.mesh import BLOCKS, make_mesh
from convex_optimization_tpu.parallel.sharded import (
    _state_specs,
    sharded_bcd as j_sharded_bcd,
    sharded_fista as j_sharded_fista,
)
from convex_optimization_tpu.solvers.batched_path import (
    batched_lambda_path as j_batched_lambda_path,
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
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import MAX_BATCH
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.parallel.mesh import ColumnGroup
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from test_torch_sharded_ranks import (
    run_cpu_ranks,
    solve_job,
    solves_and_paths_job,
)

M, N, BLOCK = 64, 256, 16
NB = 512              # the batched paths: B = 128, two blocks a rank
N_ODD = 360           # 8 x 45: every pad-free width gives an odd count
NGROUPS = 32          # 8 columns each: 2 per BCD block
LAM2 = 0.05
SCREEN_FISTA = dict(tol=1e-5, max_iters=300, gap_every=10, screen_every=1)
SCREEN_BCD = dict(tol=1e-5, max_iters=100, gap_every=5, screen_every=1,
                  use_pallas=True)
PATH_CFG = dict(tol=1e-6, max_iters=2000, gap_every=10, block_size=BLOCK,
                stall_checks=10)
BATCH_CFG = dict(tol=1e-5, max_iters=3000, gap_every=10, stall_checks=10)
CHUNK_CFG = dict(tol=1e-5, max_iters=3000, gap_every=10, stall_checks=10)
PATH_KW = dict(path_len=4, lam_min_frac=0.1)
BATCH_KW = dict(path_len=4, lam_min_frac=0.2)
ODD_KW = dict(path_len=3, lam_min_frac=0.3)     # the row mask's too
MARGIN = 1e-4         # screen margins below this (relative) may flip
X_ATOL = {"fista": 5e-5, "bcd": 5e-4}


def _penalties(A, b, lam1):
    """problem_from_numpy's penalty arguments of the three kinds."""
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


@pytest.fixture(scope="module")
def instance():
    inst, A, b = make_lasso_instance_host(11, M, N, device="cpu")
    pens = _penalties(A, b, float(inst.problem.penalty.lam1))
    L_A = float(np.linalg.norm(A, 2) ** 2 * 1.02)
    block_L = block_power_t(inst.problem.with_block(BLOCK).A_t).numpy()
    _, A_b, b_b = make_lasso_instance_host(12, M, NB, device="cpu")
    _, A_o, b_o = make_lasso_instance_host(13, M, N_ODD, device="cpu")
    rm = (np.random.default_rng(7).uniform(size=M) < 0.75).astype(
        np.float32)
    return dict(A=A, b=b, pens=pens, L_A=L_A, block_L=block_L, A_b=A_b,
                b_b=b_b, pens_b=_penalties(A_b, b_b, 0.0), A_o=A_o, b_o=b_o,
                row_mask=rm)


def _solve_runs(inst):
    """(name, run) of the screened solves, fed as the JAX solvers are."""
    runs = []
    for kind in ("l1", "nonneg_l1", "group_l2"):
        pen = inst["pens"][kind]
        runs.append((("fista", kind, "psum"), dict(
            method="fista", pen=pen,
            L_total=inst["L_A"] + pen.get("lam2", 0.0),
            cfg=dict(SCREEN_FISTA, consensus="psum"))))
        runs.append((("bcd", kind, "psum"), dict(
            method="bcd", pen=pen, block_L=inst["block_L"], block=BLOCK,
            cfg=dict(SCREEN_BCD, consensus="psum"))))
    runs.append((("bcd", "l1", "ring"), dict(
        method="bcd", pen=inst["pens"]["l1"], block_L=inst["block_L"],
        block=BLOCK, cfg=dict(SCREEN_BCD, consensus="ring"))))
    return runs


def _path_runs(inst):
    """(name, run) of the sharded paths: sequential on (A, b), batched on
    (A_b, b_b), the fallback on (A_o, b_o)."""
    runs = []
    for kind in ("l1", "group_l2"):
        for method in ("fista", "bcd_pallas"):
            runs.append((("seq", method, kind), dict(
                pen=inst["pens"][kind], cfg=PATH_CFG,
                kw=dict(PATH_KW, method=method))))
    batch = []
    for kind in ("l1", "group_l2"):
        batch.append((("batch", "bcd_batch", kind), dict(
            pen=inst["pens_b"][kind], cfg=BATCH_CFG,
            kw=dict(BATCH_KW, method="bcd_batch"))))
    batch.append((("batch", "chunked", "l1"), dict(
        pen=inst["pens_b"]["l1"], cfg=CHUNK_CFG,
        kw=dict(method="bcd_batch", lambdas=_chunk_grid(inst)))))
    batch.append((("batch", "row_mask", "l1"), dict(
        pen=inst["pens_b"]["l1"], cfg=BATCH_CFG,
        kw=dict(ODD_KW, row_mask=inst["row_mask"]))))
    odd = [(("odd", "bcd_batch", "l1"), dict(
        pen=dict(penalty_kind="l1", lam1=0.0), cfg=CHUNK_CFG,
        kw=dict(ODD_KW, method="bcd_batch")))]
    return runs, batch, odd


def _chunk_grid(inst):
    """MAX_BATCH + 2 points from 0.95 to 0.3 lam_max: two chunks."""
    lmax = float(np.abs(inst["A_b"].T @ inst["b_b"]).max())
    return np.geomspace(0.95 * lmax, 0.3 * lmax, MAX_BATCH + 2).astype(
        np.float32)


_cache: dict = {}


def _ranks(inst, tmp_path_factory):
    """Every rank-side run at P = 2, in one launch: the screened solves,
    then the paths on each of the three instances."""
    if "p2" not in _cache:
        seq, batch, odd = _path_runs(inst)
        paths = ((seq, inst["A"], inst["b"]),
                 (batch, inst["A_b"], inst["b_b"]),
                 (odd, inst["A_o"], inst["b_o"]))
        ranks = run_cpu_ranks(
            solves_and_paths_job, 2, tmp_path_factory.mktemp("sharded_path"),
            (inst["A"], inst["b"], inst["pens"]["l1"],
             [r for _, r in _solve_runs(inst)]),
            [(A, b, [r for _, r in runs]) for runs, A, b in paths])
        (s0, p0), (s1, p1) = ranks
        out = {}
        for (name, _), got, other in zip(_solve_runs(inst), s0, s1):
            np.testing.assert_array_equal(other["x"], got["x"])
            out[name] = got
        for (runs, _, _), res0, res1 in zip(paths, p0, p1):
            for (name, _), r0, r1 in zip(runs, res0, res1):
                np.testing.assert_array_equal(r0["xs"], r1["xs"])
                np.testing.assert_array_equal(r0["gaps"], r1["gaps"])
                out[name] = r0
        _cache["p2"] = out
    return _cache["p2"]


def _jax_problem(A, b, pen):
    kind = pen["penalty_kind"]
    jpen = JPenalty(lam1=jnp.asarray(pen["lam1"], jnp.float32), kind=kind,
                    ngroups=pen.get("ngroups", 0),
                    weights=(jnp.asarray(pen["weights"]) if "weights" in pen
                             else None))
    return JProblem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=jpen,
                    lam2=pen.get("lam2", 0.0))


def _jax_screened(inst, run, P):
    """The JAX sharded solver of ``run`` at P devices, screening, fed its
    L_total or block_L, as solve_sharded places its data."""
    jp = _jax_problem(inst["A"], inst["b"], run["pen"])
    mesh = make_mesh(P)
    ps = dataclasses.replace(
        jp, A=jax.device_put(jp.A, NamedSharding(mesh, PS(None, BLOCKS))),
        b=jax.device_put(jp.b, NamedSharding(mesh, PS())))
    kw = dict(run["cfg"])
    kw.pop("use_pallas", None)
    if kw["consensus"] == "ring":
        kw["unroll_checks"] = True
    cfg = JSolverConfig(**kw)
    state = jax.device_put(
        j_init_state(ps, None, cfg),
        jax.tree.map(lambda sp: NamedSharding(mesh, sp), _state_specs(),
                     is_leaf=lambda v: isinstance(v, PS)))
    if run["method"] == "fista":
        fn, args = j_sharded_fista(
            ps, jnp.asarray(run["L_total"], jnp.float32), state, cfg, mesh)
    else:
        fn, args = j_sharded_bcd(ps, jnp.asarray(run["block_L"]), state,
                                 cfg, mesh)
    return fn(*args)


def _screen_margin(A, b, pen, x):
    """Per column, the relative distance of the gap-safe test from its
    threshold at x, in f64 (``Penalty.screen_keep`` without the rounding
    terms; a group's columns share its group's)."""
    A = A.astype(np.float64)
    x = np.asarray(x, np.float64)
    lam1, lam2 = pen["lam1"], pen.get("lam2", 0.0)
    r = A @ x - b
    z = -A.T @ r - lam2 * x
    kind = pen["penalty_kind"]
    rr = r @ r + lam2 * (x @ x)
    if kind == "group_l2":
        w = np.asarray(pen["weights"], np.float64)
        gz = np.linalg.norm(z.reshape(NGROUPS, -1), axis=1)
        dual = (gz / w).max() / lam1
        g_val = lam1 * (w * np.linalg.norm(x.reshape(NGROUPS, -1),
                                           axis=1)).sum()
    else:
        dual = (np.abs(z) if kind == "l1" else z).max() / lam1
        g_val = lam1 * np.abs(x).sum()
    alpha = min(max(-(r @ b) / rr, 0.0), 1.0 / dual)
    primal = 0.5 * rr + g_val
    gap = primal - (alpha * -(r @ b) - 0.5 * alpha ** 2 * rr)
    radius = np.sqrt(2.0 * max(gap, 0.0))
    cn = np.sqrt((A * A).sum(axis=0) + lam2)
    if kind == "group_l2":
        gcol = np.sqrt((cn.reshape(NGROUPS, -1) ** 2).sum(axis=1))
        test = (np.linalg.norm((alpha * z).reshape(NGROUPS, -1), axis=1)
                + radius * gcol)
        return np.repeat(np.abs(test - lam1 * w) / (lam1 * w),
                         A.shape[1] // NGROUPS)
    wit = alpha * (np.abs(z) if kind == "l1" else z)
    return np.abs(wit + radius * cn - lam1) / lam1


def _check_screened(inst, got, run, P):
    final = _jax_screened(inst, run, P)
    method = run["method"]
    assert sum(got["launches"].values()) == 0           # plain versions
    assert got["converged"] == bool(final.best_rel_gap <= run["cfg"]["tol"])
    np.testing.assert_allclose(got["x"], np.asarray(final.x_best),
                               atol=X_ATOL[method])
    keep_j = np.asarray(final.keep_mask)
    assert (~keep_j).sum() > 0, "the JAX run screened nothing"
    differ = np.nonzero(keep_j != got["keep"])[0]
    margin = _screen_margin(inst["A"], inst["b"], run["pen"],
                            np.asarray(final.x))
    assert (margin[differ] < MARGIN).all(), (
        f"screened columns {differ.tolist()} differ with margins "
        f"{margin[differ].tolist()}")
    return got


SCREEN_CASES = [(method, kind, "psum") for kind in ("l1", "nonneg_l1",
                                                    "group_l2")
                for method in ("fista", "bcd")] + [("bcd", "l1", "ring")]


@pytest.mark.parametrize("method,kind,consensus", SCREEN_CASES)
def test_screened_sharded_solver_matches_jax(instance, tmp_path_factory,
                                             method, kind, consensus):
    out = _ranks(instance, tmp_path_factory)
    run = dict(_solve_runs(instance))[(method, kind, consensus)]
    got = _check_screened(instance, out[(method, kind, consensus)], run, 2)
    if kind == "nonneg_l1":
        assert (got["x"] >= 0).all()


def test_screened_sharded_fista_at_4_ranks(instance, tmp_path_factory):
    """The screened FISTA (l1) over 4 ranks against JAX on 4 devices, and
    ``solve(mesh=, screen_every=1)`` reporting the columns it froze."""
    run = dict(_solve_runs(instance))[("fista", "l1", "psum")]
    api = dict(method="fista", api=True, pen=run["pen"],
               cfg=dict(SCREEN_FISTA, max_iters=2000))
    got = run_cpu_ranks(solve_job, 4, tmp_path_factory.mktemp("p4"),
                        instance["A"], instance["b"], run["pen"], [run, api])
    for other in got[1:]:
        np.testing.assert_array_equal(other[0]["x"], got[0][0]["x"])
    _check_screened(instance, got[0][0], run, 4)
    res = got[0][1]
    assert res["method"] == "sharded_fista" and res["converged"]
    p = cot.problem_from_numpy(instance["A"], instance["b"], device="cpu",
                               **run["pen"])
    one = cot.solve(p, "fista", **SCREEN_FISTA)
    np.testing.assert_allclose(res["x"], one.x.numpy(), atol=5e-5)


def _check_path(got, want, tol, atol):
    np.testing.assert_allclose(got["lambdas"], np.asarray(want.lambdas),
                               rtol=1e-5)
    assert got["method_used"] == want.method_used
    np.testing.assert_allclose(got["xs"], np.asarray(want.xs), atol=atol)
    gj = np.asarray(want.gaps)
    ok = ((got["gaps"] <= tol) & (gj <= tol)) \
        | (got["gaps"] <= np.maximum(1e-5, 3.0 * gj))
    assert ok.all(), (got["gaps"], gj)


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("method", ["fista", "bcd_pallas"])
def test_sequential_sharded_path_matches_jax(instance, tmp_path_factory,
                                             method, kind):
    got = _ranks(instance, tmp_path_factory)[("seq", method, kind)]
    assert sum(got["launches"].values()) == 0
    jp = _jax_problem(instance["A"], instance["b"], instance["pens"][kind])
    want = j_lambda_path(jp, JSolverConfig(**PATH_CFG), mesh=make_mesh(2),
                         method=method, **PATH_KW)
    assert got["method_used"] == f"{method}+sharded"
    _check_path(got, want, PATH_CFG["tol"],
                X_ATOL["fista" if method == "fista" else "bcd"])


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
def test_batched_sharded_path_matches_jax(instance, tmp_path_factory, kind):
    got = _ranks(instance, tmp_path_factory)[("batch", "bcd_batch", kind)]
    jp = _jax_problem(instance["A_b"], instance["b_b"],
                      instance["pens_b"][kind])
    want = j_lambda_path(jp, JSolverConfig(**BATCH_CFG), mesh=make_mesh(2),
                         method="bcd_batch", **BATCH_KW)
    assert got["method_used"] == "bcd_batch+sharded"
    _check_path(got, want, BATCH_CFG["tol"], 1e-3)


def test_batched_sharded_path_chunks_warm(instance, tmp_path_factory):
    """MAX_BATCH + 2 points run in two chunks, the second warm-started at
    the first's deepest point."""
    got = _ranks(instance, tmp_path_factory)[("batch", "chunked", "l1")]
    jp = _jax_problem(instance["A_b"], instance["b_b"],
                      instance["pens_b"]["l1"])
    want = j_batched_lambda_path(jp, JSolverConfig(**CHUNK_CFG),
                                 lambdas=jnp.asarray(_chunk_grid(instance)),
                                 mesh=make_mesh(2))
    assert got["xs"].shape == (MAX_BATCH + 2, NB)
    assert got["converged"].all()
    _check_path(got, want, CHUNK_CFG["tol"], 1e-3)


def test_batched_sharded_path_row_mask(instance, tmp_path_factory):
    got = _ranks(instance, tmp_path_factory)[("batch", "row_mask", "l1")]
    jp = _jax_problem(instance["A_b"], instance["b_b"],
                      instance["pens_b"]["l1"])
    want = j_batched_lambda_path(jp, JSolverConfig(**BATCH_CFG),
                                 row_mask=jnp.asarray(instance["row_mask"]),
                                 mesh=make_mesh(2), **ODD_KW)
    _check_path(got, want, BATCH_CFG["tol"], 1e-3)


def test_batched_sharded_indivisible_falls_back(instance, tmp_path_factory):
    """No pad-free width's blocks divide over two ranks (JAX picks 3 of
    120): the gate warns and the sharded sequential bcd_pallas path runs,
    as in JAX."""
    got = _ranks(instance, tmp_path_factory)[("odd", "bcd_batch", "l1")]
    assert any("bcd_batch gate failed" in w and "does not divide" in w
               for w in got["warnings"]), got["warnings"]
    assert got["method_used"] == "bcd_pallas+sharded"
    assert got["xs"].shape == (3, N_ODD)
    jp = _jax_problem(instance["A_o"], instance["b_o"],
                      dict(penalty_kind="l1", lam1=0.0))
    with pytest.warns(UserWarning, match="bcd_batch gate failed"):
        want = j_lambda_path(jp, JSolverConfig(**CHUNK_CFG),
                             mesh=make_mesh(2), method="bcd_batch", **ODD_KW)
    assert want.method_used == got["method_used"]


def _raised(fn):
    try:
        fn()
    except Exception as e:                # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", [dict(method="nope"),
                                dict(compact=True)])
def test_sharded_path_refusals_match_jax(instance, kw):
    """Both raise before any collective, so a group of 2 that no rank
    joined serves."""
    p = cot.problem_from_numpy(instance["A"], instance["b"], device="cpu",
                               **instance["pens"]["l1"])
    g = ColumnGroup(group=None, rank=0, size=2, backend="gloo",
                    device=torch.device("cpu"), global_ranks=(0, 1))
    jp = _jax_problem(instance["A"], instance["b"], instance["pens"]["l1"])
    got = _raised(lambda: cot.lambda_path(p, SolverConfig(), path_len=3,
                                          mesh=g, **kw))
    want = _raised(lambda: j_lambda_path(jp, JSolverConfig(), path_len=3,
                                         mesh=make_mesh(2), **kw))
    assert got is not None and got == want
