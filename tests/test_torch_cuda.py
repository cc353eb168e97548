"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the card.  Every test needs a CUDA card and skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine without
them: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerances: the kernels and the plain versions (cuBLAS matvecs with TF32
off) sum in different orders in f32, so results differ by rounding only:
relative 1e-5 for one pass over A (K2, K3, one K1 sweep), 1e-4 for the
48-iteration power estimate (K4).
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


def test_wrappers_count_launches(cuda):
    p, x = _data(256, 1024, 32, cuda)
    before = dict(_build.launches)
    ax_minus_b_t(p.A_t, x, p.b)
    neg_at_r_t(p.A_t, p.b, x, 0.0)
    block_power_t(p.A_t)
    for name in ("ax_minus_b_t", "neg_at_r_t", "block_power_t"):
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
