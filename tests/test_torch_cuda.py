"""The port's CUDA kernels (K1-K7) against their plain PyTorch versions on
the card.  Every test needs a CUDA card and skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine without
them: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerances: the kernels and the plain versions (cuBLAS matvecs with TF32
off) sum in different orders in f32, so results differ by rounding only:
relative 1e-5 for one pass over A (K2, K3, one K1 or K5 sweep, K6, K7),
1e-4 for the 48-iteration power estimate (K4).  K5 with a 0/1 row mask
equals K5 on a masked copy of A bit for bit (torch.equal).
"""

import numpy as np
import pytest
import torch

from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    block_steps,
    sweep_t,
    sweep_t_plain,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    ax_minus_b_batch_t,
    ax_minus_b_batch_t_plain,
    batch_sweep_t,
    batch_sweep_t_plain,
    neg_at_r_batch_t,
    neg_at_r_batch_t_plain,
    rows_of,
)
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    ax_minus_b_t_plain,
    block_power_t,
    block_power_t_plain,
    neg_at_r_t,
    neg_at_r_t_plain,
    witness_gamma,
)

pytestmark = pytest.mark.cuda

SHAPES = [(256, 1024, 32), (200, 800, 40), (10_000, 80 * 16, 80)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(m, n, B, device, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32).T   # column-major
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x = np.where(rng.random(n) < 0.1, rng.standard_normal(n), 0.0)
    b = rng.standard_normal(m).astype(np.float32)
    p = problem_from_numpy(A, b, "l1", 0.05, lam2=0.1, block=B,
                           device=device)
    return p, torch.as_tensor(x, dtype=torch.float32, device=device)


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_matvec_kernels_match_plain(cuda, m, n, B):
    p, x = _data(m, n, B, cuda)
    r = ax_minus_b_t(p.A_t, x, p.b)
    r_ref = ax_minus_b_t_plain(p.A_t, x, p.b)
    scale = float(torch.linalg.vector_norm(x)) * float(
        torch.linalg.vector_norm(p.A_t)) + float(p.b.abs().max())
    assert float((r - r_ref).abs().max()) <= 1e-5 * scale
    z = neg_at_r_t(p.A_t, r_ref, x, p.lam2)
    z_ref = neg_at_r_t_plain(p.A_t, r_ref, x, p.lam2)
    torch.cuda.synchronize()
    # K3's stated rounding bound per column, ||A_j|| = 1 here
    bound = witness_gamma(m) * float(torch.linalg.vector_norm(r_ref))
    assert float((z - z_ref).abs().max()) <= bound + 1e-6


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_block_power_kernel_matches_plain(cuda, m, n, B):
    p, _ = _data(m, n, B, cuda)
    est = block_power_t(p.A_t)
    ref = block_power_t_plain(p.A_t)
    torch.testing.assert_close(est, ref, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_sweep_kernel_matches_plain(cuda, m, n, B, kind):
    p, x = _data(m, n, B, cuda)
    pen = Penalty(lam1=0.05, kind=kind)
    if kind == "nonneg_l1":
        x = x.abs()
    r = ax_minus_b_t_plain(p.A_t, x, p.b)
    steps = block_steps(block_power_t_plain(p.A_t), p.lam2)
    mask = torch.rand(n, generator=torch.Generator().manual_seed(1)) > 0.05
    mask = mask.to(cuda)
    x_k, r_k = sweep_t(p.A_t, x, r, steps, mask, pen, p.lam2)
    x_p, r_p = sweep_t_plain(p.A_t, x, r, steps, mask, pen, p.lam2)
    xs = max(1.0, float(x_p.abs().max()))
    assert float((x_k - x_p).abs().max()) <= 1e-5 * xs
    assert float(torch.linalg.vector_norm(r_k - r_p)) <= \
        1e-5 * float(torch.linalg.vector_norm(r_p))
    assert bool((x_k[~mask] == 0).all())


def _batch(p, L, seed=2):
    """An (n_blocks, L, B) X, the residual rows R = A X - b, a partly-zero
    keep mask, a 0/1 fold row mask, L geometric lam1 values and steps."""
    rng = np.random.default_rng(seed)
    nb, B, m = p.A_t.shape
    dev = p.A_t.device
    X = torch.as_tensor(0.1 * rng.standard_normal((nb, L, B)),
                        dtype=torch.float32, device=dev)
    R = ax_minus_b_batch_t_plain(p.A_t, X, p.b)
    keep = torch.as_tensor(rng.random(nb * B) > 0.05, device=dev)
    rm = torch.as_tensor((rng.random(m) > 0.2).astype(np.float32),
                         device=dev)
    zeros = torch.zeros(nb * B, device=dev)
    lmax = float(neg_at_r_t_plain(p.A_t, p.b, zeros, 0.0).abs().max())
    lam1s = torch.as_tensor(np.geomspace(0.95, 0.01, L) * lmax,
                            dtype=torch.float32, device=dev)
    steps = block_steps(block_power_t_plain(p.A_t), p.lam2)
    return X, R, keep, rm, lam1s, steps


def _sweeps_close(X_k, R_k, X_p, R_p, tol=1e-5):
    assert float((X_k - X_p).abs().max()) <= \
        tol * max(1.0, float(X_p.abs().max()))
    assert float(torch.linalg.vector_norm(R_k - R_p)) <= \
        tol * float(torch.linalg.vector_norm(R_p))


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_batch_matvec_kernels_match_plain(cuda, m, n, B):
    p, _ = _data(m, n, B, cuda)
    X, R, _, _, _, _ = _batch(p, 10)
    R_k = ax_minus_b_batch_t(p.A_t, X, p.b)
    # per element: 1e-5 (||A[i, :]|| ||x_l|| + |b_i|)
    row = torch.linalg.vector_norm(p.A_t, dim=(0, 1))
    xn = torch.linalg.vector_norm(rows_of(X), dim=1)
    tol = 1e-5 * (xn[:, None] * row[None, :] + p.b.abs()[None, :])
    assert bool(((R_k - R).abs() <= tol).all())
    Z_k = neg_at_r_batch_t(p.A_t, R, X, p.lam2)
    Z_p = neg_at_r_batch_t_plain(p.A_t, R, X, p.lam2)
    # per element: 1e-5 (||A_k|| ||r_l|| + lam2 |x|), ||A_k|| = 1 here
    rn = torch.linalg.vector_norm(R, dim=1)
    tolz = 1e-5 * (rn[None, :, None] + p.lam2 * X.abs())
    assert bool(((Z_k - Z_p).abs() <= tolz).all())


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_batch_sweep_kernel_matches_plain(cuda, m, n, B, kind):
    p, _ = _data(m, n, B, cuda)
    X, R, keep, _, lam1s, steps = _batch(p, 4)
    pen = Penalty(lam1=1.0, kind=kind)
    if kind == "nonneg_l1":
        X = X.abs()
        R = ax_minus_b_batch_t_plain(p.A_t, X, p.b)
    X_k, R_k = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep)
    X_p, R_p = batch_sweep_t_plain(p.A_t, X, R, steps, lam1s, p.lam2, pen,
                                   keep)
    _sweeps_close(X_k, R_k, X_p, R_p)
    assert bool((rows_of(X_k)[:, ~keep] == 0).all())


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_masked_batch_sweep_kernel_is_exact_vs_masked_copy(cuda, m, n, B):
    p, _ = _data(m, n, B, cuda)
    X, R, keep, rm, lam1s, steps = _batch(p, 3)
    R = rm * R                      # residual rows come in masked
    pen = Penalty(lam1=1.0, kind="l1")
    X1, R1 = X2, R2 = X, R
    for _ in range(2):
        X1, R1 = batch_sweep_t(p.A_t, X1, R1, steps, lam1s, p.lam2, pen,
                               keep, rm)
        X2, R2 = batch_sweep_t(p.A_t * rm, X2, R2, steps, lam1s, p.lam2,
                               pen, keep)
    assert torch.equal(X1, X2) and torch.equal(R1, R2)
    assert bool((R1[:, rm == 0] == 0).all())
    X_p, R_p = batch_sweep_t_plain(p.A_t, X, R, steps, lam1s, p.lam2, pen,
                                   keep, rm)
    X_k, R_k = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep,
                             rm)
    _sweeps_close(X_k, R_k, X_p, R_p)


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_batch_sweep_kernel_at_one_lambda_matches_k1(cuda, m, n, B):
    p, _ = _data(m, n, B, cuda)
    X, R, keep, _, lam1s, steps = _batch(p, 1)
    pen = Penalty(lam1=float(lam1s[0]), kind="l1")
    X5, R5 = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep)
    x1, r1 = sweep_t(p.A_t, X[:, 0, :].reshape(-1), R[0], steps, keep, pen,
                     p.lam2)
    _sweeps_close(X5[:, 0, :].reshape(-1), R5[0], x1, r1)


def test_batched_path_on_card_matches_cpu(cuda):
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    inst_c, _, _ = make_lasso_instance_host(3, 64, 256, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(3, 64, 256)
    before = dict(_build.launches)
    res_c = cot.lambda_path(inst_c.problem, cfg, path_len=6)
    res_h = cot.lambda_path(inst_h.problem, cfg, path_len=6)
    for name in ("batch_sweep_t", "ax_minus_b_batch_t", "neg_at_r_batch_t"):
        assert _build.launches[name] > before.get(name, 0)
    assert res_c.method_used == res_h.method_used == "bcd_batch"
    assert bool((res_c.converged.cpu() == res_h.converged).all())
    for l, lam in enumerate(res_c.lambdas.tolist()):
        if bool(res_c.converged[l]):
            gap = cot.duality_gap(inst_c.problem.with_lam1(lam), res_c.xs[l],
                                  precise=True)
            assert float(gap.rel_gap) <= 2e-6
    torch.testing.assert_close(res_c.xs.cpu(), res_h.xs, rtol=0, atol=5e-3)


def test_wrappers_count_launches(cuda):
    p, x = _data(256, 1024, 32, cuda)
    before = dict(_build.launches)
    ax_minus_b_t(p.A_t, x, p.b)
    neg_at_r_t(p.A_t, p.b, x, 0.0)
    block_power_t(p.A_t)
    X, R, _, _, lam1s, steps = _batch(p, 2)
    batch_sweep_t(p.A_t, X, R, steps, lam1s, 0.0, Penalty(1.0))
    ax_minus_b_batch_t(p.A_t, X, p.b)
    neg_at_r_batch_t(p.A_t, R, X, 0.0)
    for name in ("ax_minus_b_t", "neg_at_r_t", "block_power_t",
                 "batch_sweep_t", "ax_minus_b_batch_t", "neg_at_r_batch_t"):
        assert _build.launches[name] == before.get(name, 0) + 1


def test_wrappers_reject_bad_operands(cuda):
    p, x = _data(256, 1024, 32, cuda)
    with pytest.raises(ValueError):
        ax_minus_b_t(p.A_t, x.double(), p.b)
    with pytest.raises(ValueError):
        neg_at_r_t(p.A_t, p.b.cpu(), x, 0.0)
    group = Penalty(lam1=0.05, kind="group_l2", ngroups=32)
    with pytest.raises(NotImplementedError):
        sweep_t(p.A_t, x, -p.b, torch.ones(32, device=cuda), None, group,
                0.0)
    X, R, _, _, lam1s, steps = _batch(p, 2)
    with pytest.raises(NotImplementedError):
        batch_sweep_t(p.A_t, X, R, steps, lam1s, 0.0, group)
    with pytest.raises(ValueError):
        batch_sweep_t(p.A_t, X, R.double(), steps, lam1s, 0.0, Penalty(1.0))
    with pytest.raises(ValueError):
        neg_at_r_batch_t(p.A_t, R, X[:, :1].contiguous(), 0.0)


def test_solve_on_card_matches_cpu(cuda):
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    kw = dict(block_size=40, gap_every=10, stall_checks=15, tol=1e-6,
              max_iters=20_000)
    inst_c, A, b = make_lasso_instance_host(0, 200, 800, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(0, 200, 800)
    res_c = cot.solve(inst_c.problem, "bcd_pallas", **kw)
    res_h = cot.solve(inst_h.problem, "bcd_pallas", **kw)
    assert abs(res_c.iterations - res_h.iterations) <= 10
    pr = cot.polish_support(inst_c.problem, res_c.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert pr.rel_gap <= 1e-6
