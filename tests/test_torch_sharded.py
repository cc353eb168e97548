"""The column-sharded solvers and their collectives in the port, run as P =
2 and 4 gloo ranks on the CPU (K2-K4 and K8 plain versions), against the
JAX package's sharded solvers on the conftest's 8-device CPU mesh fed the
same L_total / block_L, with l1 and with a weighted group_l2 whose groups
split over the ranks and, in the ring's two half-slabs, over the halves.

Tolerances, as the JAX package's own sharding tests hold the sharded
solvers to the unsharded ones (tests/test_sharding.py,
tests/test_collectives.py): primal histories at matching checks rtol 1e-4,
final x atol 5e-5 (FISTA) and 5e-4 (BCD, whose Jacobi merge and stall
boundary move with rounding); the collectives equal psum to f32 rounding
of a sum of P terms.  The JAX ring runs need ``unroll_checks=True`` on
XLA:CPU (a static check loop: small max_iters).

Each P spawns its ranks once per module (``test_torch_sharded_ranks``) and
the tests read the cached results.
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
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.fista import init_state as j_init_state
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.ops.matvec import block_power_t
from convex_optimization_tpu_torch.parallel.mesh import ColumnGroup
from convex_optimization_tpu_torch.parallel.sharded import shard_columns
from test_torch_sharded_ranks import (
    collectives_job,
    run_cpu_ranks,
    solve_job,
)
from tests.torch_threads import worker_threads  # noqa: F401

M, N, BLOCK = 64, 256, 16
FISTA_CFG = dict(tol=1e-5, max_iters=300, gap_every=10)
BCD_CFG = dict(tol=1e-5, max_iters=100, gap_every=5)
CONSENSUS = ("psum", "ring", "reduce_scatter")
CERT_TOL = 1e-7
NGROUPS = 32                      # 8 columns each: 2 per BCD block
GROUP_CONSENSUS = ("psum", "ring")


@pytest.fixture(scope="module")
def instance():
    inst, A, b = make_lasso_instance_host(11, M, N, device="cpu")
    p = inst.problem
    lam1 = float(p.penalty.lam1)
    L_total = float(np.linalg.norm(A, 2) ** 2 * 1.02)
    block_L = block_power_t(p.with_block(BLOCK).A_t).numpy()
    w = np.random.default_rng(5).uniform(0.5, 1.5, NGROUPS).astype(
        np.float32)
    g_norms = np.linalg.norm((A.T @ b).reshape(NGROUPS, -1), axis=1)
    group = dict(penalty_kind="group_l2", ngroups=NGROUPS, weights=w,
                 lam1=float(0.3 * (g_norms / w).max()))
    return dict(A=A, b=b, lam1=lam1, L_total=L_total, block_L=block_L,
                problem=p, group=group)


def _runs(inst):
    runs = []
    for c in CONSENSUS:
        runs.append(dict(method="fista", L_total=inst["L_total"],
                         cfg=dict(FISTA_CFG, consensus=c)))
    for c in CONSENSUS:
        runs.append(dict(method="bcd", block_L=inst["block_L"], block=BLOCK,
                         cfg=dict(BCD_CFG, consensus=c, use_pallas=True)))
    runs.append(dict(method="bcd_pallas", api=True,
                     cfg=dict(tol=CERT_TOL, max_iters=100,
                              block_size=BLOCK, certify=True)))
    for c in GROUP_CONSENSUS:
        runs.append(dict(method="fista", L_total=inst["L_total"],
                         pen=inst["group"],
                         cfg=dict(FISTA_CFG, consensus=c)))
    for c in GROUP_CONSENSUS:
        runs.append(dict(method="bcd", block_L=inst["block_L"], block=BLOCK,
                         pen=inst["group"],
                         cfg=dict(BCD_CFG, consensus=c, use_pallas=True)))
    return runs


CERT_RUN = 6                      # the solve(mesh=..., certify=True) run


_cache: dict = {}


def _ranks(P, inst, tmp_path_factory):
    """Both jobs at P ranks, spawned once per P."""
    if P not in _cache:
        pen = dict(penalty_kind="l1", lam1=inst["lam1"])
        solves = run_cpu_ranks(solve_job, P,
                               tmp_path_factory.mktemp(f"s{P}"), inst["A"],
                               inst["b"], pen, _runs(inst))
        rng = np.random.default_rng(P)
        vecs = [rng.standard_normal((P, n)).astype(np.float32)
                for n in (4 * P, 4 * P + 1)]          # even and ragged
        coll = run_cpu_ranks(collectives_job, P,
                             tmp_path_factory.mktemp(f"c{P}"), vecs)
        _cache[P] = (solves, coll, vecs)
    return _cache[P]


def _jax_run(inst, P, method, cfg_kw, pen=None):
    """The JAX sharded solver at P devices with the given L_total or
    block_L, as solve_sharded places its data; ``pen``: the port's
    problem_from_numpy penalty arguments (default: the instance's l1)."""
    if pen is None:
        jpen = JPenalty(lam1=jnp.asarray(inst["lam1"], jnp.float32))
    else:
        jpen = JPenalty(lam1=jnp.asarray(pen["lam1"], jnp.float32),
                        kind=pen["penalty_kind"], ngroups=pen["ngroups"],
                        weights=jnp.asarray(pen["weights"]))
    jp = JProblem(A=jnp.asarray(inst["A"]), b=jnp.asarray(inst["b"]),
                  penalty=jpen)
    mesh = make_mesh(P)
    ps = dataclasses.replace(
        jp, A=jax.device_put(jp.A, NamedSharding(mesh, PS(None, BLOCKS))),
        b=jax.device_put(jp.b, NamedSharding(mesh, PS())))
    kw = dict(cfg_kw)
    kw.pop("use_pallas", None)
    if kw["consensus"] == "ring":
        kw["unroll_checks"] = True
    cfg = JSolverConfig(**kw)
    state = jax.device_put(
        j_init_state(ps, None, cfg),
        jax.tree.map(lambda sp: NamedSharding(mesh, sp), _state_specs(),
                     is_leaf=lambda v: isinstance(v, PS)))
    if method == "fista":
        fn, args = j_sharded_fista(ps, jnp.asarray(inst["L_total"],
                                                   jnp.float32),
                                   state, cfg, mesh)
    else:
        fn, args = j_sharded_bcd(ps, jnp.asarray(inst["block_L"]), state,
                                 cfg, mesh)
    return fn(*args)


def _check_against_jax(inst, solves, i, P, method):
    run = _runs(inst)[i]
    cfg_kw = run["cfg"]
    got = solves[0][i]
    for other in solves[1:]:             # x is gathered to every rank
        np.testing.assert_array_equal(other[i]["x"], got["x"])
    assert sum(got["launches"].values()) == 0       # plain versions
    final = _jax_run(inst, P, method, cfg_kw, run.get("pen"))
    jh = final.history.trimmed()
    assert got["converged"] == bool(final.best_rel_gap <= cfg_kw["tol"])
    assert abs(got["k"] - int(final.k)) <= cfg_kw["gap_every"]
    k = min(len(got["history"]["primal"]), len(jh["primal"]))
    np.testing.assert_allclose(got["history"]["primal"][:k],
                               np.asarray(jh["primal"])[:k], rtol=1e-4)
    np.testing.assert_allclose(got["x"], np.asarray(final.x_best),
                               atol=5e-5 if method == "fista" else 5e-4)
    return got


@pytest.mark.parametrize("consensus", CONSENSUS)
@pytest.mark.parametrize("method", ["fista", "bcd"])
@pytest.mark.parametrize("P", [2, 4])
def test_sharded_solver_matches_jax(instance, tmp_path_factory, P, method,
                                    consensus):
    solves, _, _ = _ranks(P, instance, tmp_path_factory)
    i = CONSENSUS.index(consensus) + (3 if method == "bcd" else 0)
    _check_against_jax(instance, solves, i, P, method)


@pytest.mark.parametrize("consensus", GROUP_CONSENSUS)
@pytest.mark.parametrize("method", ["fista", "bcd"])
@pytest.mark.parametrize("P", [2, 4])
def test_sharded_group_solver_matches_jax(instance, tmp_path_factory, P,
                                          method, consensus):
    """Weighted group_l2: each rank's slice of the groups and weights
    (and, with the ring, each half-slab's) against the JAX package's."""
    solves, _, _ = _ranks(P, instance, tmp_path_factory)
    i = (CERT_RUN + 1 + GROUP_CONSENSUS.index(consensus)
         + (len(GROUP_CONSENSUS) if method == "bcd" else 0))
    got = _check_against_jax(instance, solves, i, P, method)
    assert 0 < np.count_nonzero(got["x"]) < len(got["x"])


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_solve_certifies_in_f64(instance, tmp_path_factory, P):
    """solve(mesh=..., certify=True): the f32 solve stops at max_iters
    above tol and the f64 polish certifies the gathered x."""
    solves, _, _ = _ranks(P, instance, tmp_path_factory)
    got = solves[0][CERT_RUN]
    assert got["method"] == "sharded_bcd" and got["converged"]
    assert got["rel_gap"] <= CERT_TOL
    gap = cot.duality_gap(instance["problem"], torch.from_numpy(got["x"]),
                          precise=True)
    assert float(gap.rel_gap) <= CERT_TOL


@pytest.mark.parametrize("name", ["ring", "ring_async", "ring_chunked",
                                  "reduce_scatter"])
@pytest.mark.parametrize("P", [2, 4])
def test_collectives_equal_psum(instance, tmp_path_factory, P, name):
    _, coll, vecs = _ranks(P, instance, tmp_path_factory)
    for v in vecs:
        want = v.astype(np.float64).sum(axis=0)
        for rank in range(P):
            got = coll[rank][v.shape[1]]
            np.testing.assert_allclose(got[name], got["psum"], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got[name], want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(got["pmax"], v.max(axis=0))
            assert got["input_kept"]


@pytest.mark.parametrize("n,ngroups,block,match", [
    (100, 0, 20, "n=100 must divide over 8 shards"),
    (384, 12, 16, "ngroups must divide over shards"),
    (256, 0, 64, "n_blocks must divide evenly over mesh devices"),
])
def test_shard_columns_refuses_what_jax_refuses(n, ngroups, block, match):
    kind = "group_l2" if ngroups else "l1"
    inst, _, _ = make_lasso_instance_host(7, 32, n, penalty_kind=kind,
                                          ngroups=ngroups, device="cpu")
    g = ColumnGroup(group=None, rank=0, size=8, backend="gloo",
                    device=torch.device("cpu"), global_ranks=tuple(range(8)))
    with pytest.raises(ValueError, match=match):
        shard_columns(inst.problem, g, block)


def test_shard_columns_is_a_view_of_the_rank_slab():
    inst, A, _ = make_lasso_instance_host(7, 32, 256, device="cpu")
    g = ColumnGroup(group=None, rank=2, size=4, backend="gloo",
                    device=torch.device("cpu"), global_ranks=(0, 1, 2, 3))
    loc = shard_columns(inst.problem, g, 16)
    assert tuple(loc.A_t.shape) == (4, 16, 32)
    assert loc.A_t.data_ptr() == inst.problem.A_rows[128].data_ptr()
    np.testing.assert_array_equal(loc.A.numpy(), A[:, 128:192])
