"""Gap-safe screening in the port (plain versions on the CPU) against the
JAX package on the same numpy arrays, and the safety properties of
``tests/test_screening.py`` held by the port's own solvers.

Tolerances and why: ``screen_keep`` gets the same f32 inputs in both
packages and does the same arithmetic, so the masks must be equal; a
screened solve freezes only coordinates that are zero at the optimum, so it
must end within 5e-5 of the unscreened solve (the JAX test's bound), with
the same support.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu as co
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.core.objective import (
    dual_witness,
    duality_gap,
)
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.parallel.mesh import ColumnGroup
from convex_optimization_tpu_torch.solvers.screening import (
    compact_problem,
    gap_safe_keep_mask,
)
from tests.torch_threads import worker_threads  # noqa: F401

M, N = 96, 384


def _instance(seed, kind, ngroups=0, lam2=0.0):
    inst, A, b = make_lasso_instance_host(seed, M, N, penalty_kind=kind,
                                          ngroups=ngroups, lam2=lam2,
                                          device="cpu")
    return inst.problem, A, b


@pytest.mark.parametrize("kind,ngroups,lam2", [("l1", 0, 0.0),
                                               ("nonneg_l1", 0, 1e-2),
                                               ("group_l2", 16, 0.0)])
def test_screen_keep_matches_jax(kind, ngroups, lam2):
    """The same witness, scaling, gap, norms and margins into both
    packages' screen_keep (group_l2 with weights): the same mask, which
    keeps some coordinates and discards others."""
    p, A, b = _instance(61, kind, ngroups, lam2)
    w = None
    if kind == "group_l2":
        w = np.random.default_rng(61).uniform(0.5, 1.5, ngroups)
        p = p.with_penalty(dataclasses.replace(
            p.penalty, weights=torch.as_tensor(w, dtype=torch.float32)))
    part = cot.solve(p, "fista", tol=1e-12, max_iters=60, gap_every=10)
    x = part.x
    r = p.residual(x)
    z = dual_witness(p, x, r)
    info = duality_gap(p, x, r, z=z)
    cn = p.col_norms()
    r_norm = torch.linalg.vector_norm(r)
    keep = p.penalty.screen_keep(z, info.alpha, info.gap, cn,
                                 r_norm=r_norm, primal=info.primal)
    jpen = co.Penalty(lam1=jnp.float32(float(p.penalty.lam1)), kind=kind,
                      ngroups=ngroups,
                      weights=None if w is None else jnp.asarray(
                          w, jnp.float32))
    j_keep = jpen.screen_keep(
        jnp.asarray(z.numpy()), jnp.asarray(info.alpha.numpy()),
        jnp.asarray(info.gap.numpy()), jnp.asarray(cn.numpy()),
        r_norm=jnp.asarray(r_norm.numpy()),
        primal=jnp.asarray(info.primal.numpy()))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    assert 0 < int(keep.sum()) < N
    # the one-shot helper screens at the same point the same way
    assert torch.equal(gap_safe_keep_mask(p, x), keep)


@pytest.mark.parametrize("kind,ngroups,lam2", [("l1", 0, 0.0),
                                               ("nonneg_l1", 0, 1e-2),
                                               ("group_l2", 16, 0.0)])
def test_screen_is_safe_along_the_solve(kind, ngroups, lam2):
    """Masks taken at coarse, mid and tight iterates keep every coordinate
    of the converged unscreened support."""
    p, _, _ = _instance(51, kind, ngroups, lam2)
    ref = cot.solve(p, "fista", tol=1e-6, max_iters=5000)
    support = (ref.x != 0).numpy()
    for iters in (10, 50, 300):
        part = cot.solve(p, "fista", tol=1e-12, max_iters=iters,
                         gap_every=10)
        keep = gap_safe_keep_mask(p, part.x).numpy()
        assert not np.any(support & ~keep), iters


@pytest.mark.parametrize("method", ["fista", "bcd_pallas"])
@pytest.mark.parametrize("kind,ngroups,lam2", [("l1", 0, 0.0),
                                               ("nonneg_l1", 0, 1e-3),
                                               ("group_l2", 16, 0.0)])
def test_screened_solve_equals_unscreened(method, kind, ngroups, lam2):
    """screen_every=1 (the screen at every check tightens the keep mask
    that FISTA's prox and K1's plain version read) ends where the
    unscreened solve ends; the final mask discards coordinates."""
    p, _, _ = _instance(52, kind, ngroups, lam2)
    kw = dict(tol=1e-5, max_iters=5000, gap_every=10, block_size=32)
    ref = cot.solve(p, method, **kw)
    scr = cot.solve(p, method, screen_every=1, **kw)
    assert scr.converged and scr.config.screen_every == 1
    assert 0 < scr.screened < N and ref.screened == 0
    torch.testing.assert_close(scr.x, ref.x, rtol=0, atol=5e-5)
    np.testing.assert_array_equal((scr.x != 0).numpy(),
                                  (ref.x != 0).numpy())


def test_screened_bcd_freezes_what_it_screens():
    """The keep mask the checks build reaches the sweep: a screened
    coordinate stays exactly 0 afterwards."""
    from convex_optimization_tpu_torch.ops.matvec import block_power_t
    from convex_optimization_tpu_torch.solvers import bcd as bcd_mod
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    p, _, _ = _instance(53, "nonneg_l1", lam2=1e-3)
    p = p.with_block(32)
    cfg = SolverConfig(tol=1e-7, max_iters=60, gap_every=10,
                       use_pallas=True, screen_every=1)
    state = bcd_mod.bcd(p, block_power_t(p.A_t), bcd_mod.init_state(p, None),
                        cfg)
    screened = ~state.keep_mask
    assert int(screened.sum()) > N // 4
    assert bool((state.x[screened] == 0).all())


def test_compact_problem_preserves_solution():
    p, _, _ = _instance(53, "l1")
    ref = cot.solve(p, "fista", tol=1e-6, max_iters=5000)
    mid = cot.solve(p, "fista", tol=1e-4, max_iters=3000)
    keep = gap_safe_keep_mask(p, mid.x)
    small, idx = compact_problem(p, keep)
    assert small.n == int(keep.sum()) < N
    res = cot.solve(small, "fista", tol=1e-6, max_iters=5000)
    x_full = torch.zeros(N)
    x_full[idx] = res.x
    torch.testing.assert_close(x_full, ref.x, rtol=0, atol=5e-5)


def test_compact_group_problem_keeps_whole_groups_and_weights():
    p, _, _ = _instance(54, "group_l2", ngroups=16)
    w = torch.linspace(0.5, 1.5, 16)
    p = p.with_penalty(dataclasses.replace(p.penalty, weights=w))
    keep = torch.zeros(N, dtype=torch.bool)
    keep[[3, 5 * 24 + 1, 5 * 24 + 2]] = True       # groups 0 and 5
    small, idx = compact_problem(p, keep)
    assert small.n == 48 and small.penalty.ngroups == 2
    torch.testing.assert_close(small.penalty.weights, w[[0, 5]])
    torch.testing.assert_close(small.A_rows, p.A_rows[idx])
    assert idx.tolist() == list(range(24)) + list(range(120, 144))


def test_sharded_solve_refuses_screening(tmp_path):
    """The column-sharded solvers screen now (they refused to before the
    sharded screening was ported; the name is kept): over a world-size-1
    gloo group in this process, ``solve(mesh=, screen_every=1)`` freezes
    columns and ends within 5e-5 of the unscreened sharded solve, with the
    same support.  More ranks: ``tests/test_torch_sharded_path.py``."""
    import torch.distributed as dist

    from convex_optimization_tpu_torch.parallel.mesh import init_multihost

    A = np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32)
    p = problem_from_numpy(A, A[:, 0].copy(), "l1", 0.1, device="cpu")
    g = init_multihost(f"file://{tmp_path}/store", 0, 1, "cpu")
    try:
        assert isinstance(g, ColumnGroup)
        for method in ("bcd_pallas", "fista"):
            kw = dict(tol=1e-6, max_iters=3000, block_size=16)
            res = cot.solve(p, method, mesh=g, screen_every=1, **kw)
            ref = cot.solve(p, method, mesh=g, **kw)
            assert 0 < res.screened < p.n and ref.screened == 0
            assert res.converged and ref.converged
            np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(),
                                       atol=5e-5)
            assert ((res.x.abs() > 1e-4) == (ref.x.abs() > 1e-4)).all()
    finally:
        dist.destroy_process_group()


def test_penalty_screen_keep_rejects_unknown_kind():
    pen = Penalty(lam1=1.0, kind="nope")
    with pytest.raises(ValueError, match="unknown penalty kind"):
        pen.screen_keep(torch.ones(4), 1.0, 0.0, torch.ones(4))
