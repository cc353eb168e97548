"""FISTA and ISTA in the port (K2/K3 plain versions on the CPU) against the
JAX package's jitted FISTA on the same instance and the same L_total.

Tolerances, as the JAX package's own sharded-vs-unsharded tests hold them
(tests/test_sharding.py): primal histories at matching checks rtol 1e-4
and the final x atol 5e-5.  f32 sums run in another order (the port's
plain K3 sums in f64 and rounds), so the iterates agree to rounding and
the runs may stop one check apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.datagen import (
    make_lasso_instance_host as j_make_host,
)
from convex_optimization_tpu.solvers.common import (
    SolverConfig as JSolverConfig,
)
from convex_optimization_tpu.solvers.fista import (
    fista as j_fista,
    init_state as j_init_state,
)
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.matvec import (
    spectral_norm_sq,
    spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.solvers.common import SolverConfig
from convex_optimization_tpu_torch.solvers.fista import fista, init_state
from tests.torch_threads import worker_threads  # noqa: F401

CASES = [("l1", 0.0, 0), ("l1", 1e-2, 0), ("nonneg_l1", 0.0, 0),
         ("group_l2", 0.0, 32)]


def _instances(kind, lam2, ngroups, seed=21, m=64, n=256):
    j_inst, _, _ = j_make_host(seed, m, n, penalty_kind=kind, lam2=lam2,
                               ngroups=ngroups)
    inst, A, b = make_lasso_instance_host(seed, m, n, penalty_kind=kind,
                                          lam2=lam2, ngroups=ngroups,
                                          device="cpu")
    return j_inst.problem, inst.problem, A


def _close_histories(h, jh):
    k = min(len(h["primal"]), len(np.asarray(jh["primal"])))
    np.testing.assert_allclose(h["primal"][:k], np.asarray(jh["primal"])[:k],
                               rtol=1e-4)


@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("kind,lam2,ngroups", CASES)
def test_fista_matches_jax(kind, lam2, ngroups, momentum):
    jp, tp, A = _instances(kind, lam2, ngroups)
    L = float(np.linalg.norm(A, 2) ** 2 * 1.02 + lam2)
    kw = dict(tol=1e-5, max_iters=2000, gap_every=10, momentum=momentum)
    jcfg = JSolverConfig(**kw)
    j_final = j_fista(jp, jnp.asarray(L, jnp.float32),
                      j_init_state(jp, None, jcfg), jcfg)
    final = fista(tp, L, init_state(tp, None), SolverConfig(**kw))
    assert final.best_rel_gap <= 1e-5
    assert abs(final.k - int(j_final.k)) <= kw["gap_every"]
    _close_histories(final.history.trimmed(), j_final.history.trimmed())
    np.testing.assert_allclose(final.x_best.numpy(),
                               np.asarray(j_final.x_best), atol=5e-5)


@pytest.mark.parametrize("method", ["fista", "ista"])
def test_solve_fista_ista_converge_and_certify(method):
    """api.solve's FISTA/ISTA branch: L_total from the K2/K3 power
    iteration, no kernel launched on the CPU, the f64 gap at x below tol,
    and certify=True turns a loose f32 stop into an f64 certificate."""
    inst, A, b = make_lasso_instance_host(3, 96, 384, device="cpu")
    p = inst.problem
    _build.reset_launches()
    res = cot.solve(p, method, tol=1e-5, max_iters=5000)
    assert res.method == method and res.converged
    assert sum(_build.launches.values()) == 0
    assert float(cot.duality_gap(p, res.x, precise=True).rel_gap) <= 2e-5
    cert = cot.solve(p, method, tol=1e-7, max_iters=30, certify=True)
    assert cert.rel_gap <= 1e-7 and cert.converged
    assert cert.x.dtype == torch.float64
    assert float(cot.duality_gap(p, cert.x, precise=True).rel_gap) <= 1e-7


def test_spectral_norm_plain_form_matches_the_k2_k3_iteration():
    inst, A, _ = make_lasso_instance_host(5, 64, 256, device="cpu")
    A_t = inst.problem.A_t
    est = float(spectral_norm_sq_t(A_t))
    assert abs(est - float(spectral_norm_sq(A_t))) <= 1e-5 * est
    assert est >= 0.999 * np.linalg.norm(A, 2) ** 2
