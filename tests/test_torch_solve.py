"""The whole slice — host instance, bcd_pallas solve, f64 support polish —
in the port (plain versions on the CPU) against the JAX package (Pallas
kernels in interpret mode) on the same host instance.

What must agree and why it may differ at all: f32 sums run in another
order, so the iterates agree to rounding and the stall rule may end the
solves one check apart (sweep counts within one gap_every); both polished
solutions must certify an f64 relative gap <= 1e-6, the JAX package's own
f64 gap at the port's solution must too, and the supports (|x| > 1e-4)
must be the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu as co
from convex_optimization_tpu.core.datagen import (
    make_lasso_instance_host as j_make_host,
)
from convex_optimization_tpu.solvers.polish import (
    polish_support as j_polish_support,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.solvers.common import SolverConfig

KW = dict(block_size=40, gap_every=10, stall_checks=15, tol=1e-6,
          max_iters=20_000)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 0.05)])
def test_slice_matches_jax(kind, lam2):
    j_inst, jA, jb = j_make_host(0, 200, 800, penalty_kind=kind, lam2=lam2)
    inst, A, b = make_lasso_instance_host(0, 200, 800, penalty_kind=kind,
                                          lam2=lam2, device="cpu")
    j_res = co.solve(j_inst.problem, "bcd_pallas", **KW)
    res = cot.solve(inst.problem, "bcd_pallas", **KW)
    assert abs(res.iterations - j_res.iterations) <= KW["gap_every"]
    np.testing.assert_allclose(res.history["rel_gap"][:3],
                               j_res.history["rel_gap"][:3], rtol=1e-4)

    j_pr = j_polish_support(j_inst.problem, j_res.x, tol=1e-6, A_host=jA,
                            b_host=jb)
    pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert j_pr.rel_gap <= 1e-6 and pr.rel_gap <= 1e-6
    j_gap = co.duality_gap(j_inst.problem, jnp.asarray(pr.x), precise=True)
    assert float(j_gap.rel_gap) <= 1e-6
    np.testing.assert_array_equal(np.abs(pr.x) > 1e-4, np.abs(j_pr.x) > 1e-4)
    assert abs(pr.rel_gap - float(cot.duality_gap(
        inst.problem, torch.from_numpy(pr.x), precise=True).rel_gap)) < 1e-9


def test_polish_without_host_copy_gathers_from_the_problem():
    inst, A, b = make_lasso_instance_host(1, 96, 384, device="cpu")
    res = cot.solve(inst.problem, "bcd_pallas", **KW)
    with_host = cot.polish_support(inst.problem, res.x, A_host=A, b_host=b)
    no_host = cot.polish_support(inst.problem, res.x.numpy())
    assert no_host.rel_gap <= 1e-6
    np.testing.assert_allclose(no_host.x, with_host.x, rtol=0, atol=1e-12)


def test_polish_expands_from_a_truncated_start():
    inst, A, b = make_lasso_instance_host(2, 96, 384, device="cpu")
    res = cot.solve(inst.problem, "bcd_pallas", **KW)
    x = res.x.numpy().copy()
    x[np.argsort(-np.abs(x))[len(np.nonzero(x)[0]) // 2:]] = 0.0
    pr = cot.polish_support(inst.problem, x, tol=1e-8, A_host=A, b_host=b)
    assert pr.rel_gap <= 1e-8
    assert pr.kept >= np.count_nonzero(res.x.numpy()) // 2


def test_bcd_and_bcd_pallas_agree_on_cpu():
    inst, _, _ = make_lasso_instance_host(3, 128, 512, device="cpu")
    a = cot.solve(inst.problem, "bcd_pallas", **KW)
    b = cot.solve(inst.problem, "bcd", **KW)
    assert a.method == "bcd_pallas" and b.method == "bcd"
    assert a.config.use_pallas and not b.config.use_pallas
    assert a.iterations == b.iterations
    assert a.rel_gap <= 1e-5 and b.rel_gap <= 1e-5
    torch.testing.assert_close(a.x, b.x, rtol=1e-4, atol=1e-5)


def test_padded_block_matches_jax_choice_and_certifies():
    # n = 804 has no multiple-of-8 divisor <= 128: both packages pad
    j_inst, jA, jb = j_make_host(4, 128, 804)
    inst, A, b = make_lasso_instance_host(4, 128, 804, device="cpu")
    kw = dict(KW, block_size=128)
    res = cot.solve(inst.problem, "bcd_pallas", **kw)
    j_res = co.solve(j_inst.problem, "bcd_pallas", **kw)
    assert res.x.shape == (804,)
    assert abs(res.iterations - j_res.iterations) <= kw["gap_every"]
    pr = cot.polish_support(inst.problem, res.x, A_host=A, b_host=b)
    assert pr.rel_gap <= 1e-6


def _active_groups(x, ngroups):
    return np.nonzero(np.abs(np.asarray(x)).reshape(ngroups, -1)
                      .sum(axis=1) > 0)[0]


def test_group_l2_solves_on_cpu_and_matches_jax():
    j_inst, _, _ = j_make_host(5, 96, 384, penalty_kind="group_l2",
                               ngroups=48)
    inst, A, b = make_lasso_instance_host(5, 96, 384,
                                          penalty_kind="group_l2",
                                          ngroups=48, device="cpu")
    kw = dict(KW, tol=1e-5)
    res = cot.solve(inst.problem, "bcd_pallas", **kw)
    j_res = co.solve(j_inst.problem, "bcd_pallas", **kw)
    assert res.converged and j_res.converged
    assert abs(res.iterations - j_res.iterations) <= kw["gap_every"]
    pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert pr.rel_gap <= 1e-6
    j_gap = co.duality_gap(j_inst.problem, jnp.asarray(pr.x), precise=True)
    assert float(j_gap.rel_gap) <= 1e-6


@pytest.mark.parametrize("lam1_frac,lam2", [(0.1, 0.0), (0.05, 0.05)])
def test_group_slice_matches_jax(lam1_frac, lam2):
    """The group lasso through solve(bcd_pallas) and the group polish, in
    both packages on the same host instance (80 groups of 10)."""
    kw = dict(lam1_frac=lam1_frac, lam2=lam2, penalty_kind="group_l2",
              ngroups=80)
    j_inst, jA, jb = j_make_host(9, 200, 800, **kw)
    inst, A, b = make_lasso_instance_host(9, 200, 800, device="cpu", **kw)
    j_res = co.solve(j_inst.problem, "bcd_pallas", **KW)
    res = cot.solve(inst.problem, "bcd_pallas", **KW)
    assert abs(res.iterations - j_res.iterations) <= KW["gap_every"]
    j_pr = j_polish_support(j_inst.problem, j_res.x, tol=1e-6, A_host=jA,
                            b_host=jb)
    pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert j_pr.rel_gap <= 1e-6 and pr.rel_gap <= 1e-6
    j_gap = co.duality_gap(j_inst.problem, jnp.asarray(pr.x), precise=True)
    assert float(j_gap.rel_gap) <= 1e-6
    active = _active_groups(pr.x, 80)
    np.testing.assert_array_equal(active, _active_groups(j_pr.x, 80))
    assert len(active) >= 2
    assert pr.kept % 10 == 0 and pr.gather_s >= 0.0


def test_result_fields_and_timing():
    inst, _, _ = make_lasso_instance_host(6, 64, 256, device="cpu")
    res = cot.solve(inst.problem, "bcd_pallas", **KW)
    assert res.iterations > 0
    assert res.wall_time_s > 0 and res.setup_time_s > 0
    assert res.nnz == int(torch.count_nonzero(res.x))
    h = res.history
    assert h["iteration"][0] == 0 and h["iteration"][-1] == res.iterations
    assert len(h["rel_gap"]) == res.iterations // KW["gap_every"] + 1
    assert np.isclose(res.rel_gap, h["rel_gap"].min())
    assert sum(_build.launches.values()) == 0


def test_stall_and_max_iters_stop_the_loop():
    inst, _, _ = make_lasso_instance_host(7, 64, 256, device="cpu")
    res = cot.solve(inst.problem, "bcd_pallas", **dict(KW, max_iters=30,
                                                      tol=1e-12))
    assert res.iterations == 30 and not res.converged
    cfg = SolverConfig(max_iters=20_000, gap_every=5, stall_checks=2,
                       tol=0.0, block_size=32)
    res = cot.solve(inst.problem, "bcd_pallas", cfg=cfg)
    rel = res.history["rel_gap"]
    # stopped after 2 checks with no new best
    assert res.iterations < 20_000
    assert min(rel[-2:]) >= rel[:-2].min()


def test_unknown_method_raises():
    inst, _, _ = make_lasso_instance_host(8, 32, 64, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        cot.solve(inst.problem, "nope")
