"""The port's CUDA kernels (K1-K10) against their plain PyTorch versions
on the card, and the column-sharded solvers as two gloo ranks sharing it.
Every test needs a CUDA card and skips without one.  This file imports
neither jax nor the JAX package, so it runs on a machine without
them: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerances: the kernels and the plain versions (cuBLAS matvecs with TF32
off) sum in different orders in f32, so results differ by rounding only:
relative 1e-5 for one pass over A (K2, one K1, K5, K8 or K9 sweep,
K6, K7; K8's payload scalars to 1e-4 of their magnitude sums, sums of n
terms in another order),
1e-4 for the 48-iteration power estimate (K4); K3 to its stated rounding
bound witness_gamma(m) ||A_j|| ||r|| per column, on which the f64 polish's
certificate rests.  K2 and K3 give the same bits on two launches, and on
unaligned or slab views as on aligned copies (torch.equal); K1 and K8
give the same bits on two launches and on unaligned views, and K8's x and
r are K1's on the same slab (torch.equal: one kernel, one plan); K9 gives
the same bits on two launches, and on an unaligned view (its scalar
instance) matches the plain version.  K5 with a 0/1
row mask equals K5 on a masked copy of A bit for bit (torch.equal), with
every penalty; K5, K6 and K7 give the same bits on two launches, and K5 on
an unaligned A_t view the bits of the aligned copy (torch.equal).
Solves and paths on the card against the same on the CPU: certified in
f64 (<= 2 tol: the f32 gap's own rounding), x within 5e-3 (two certified
iterates) and step counts within one check.  The working-set solves:
the same rounds, working sets within one bucket (a column at its
screen's threshold), the same support after the polish; ADMM, whose
balancing of rho is a discrete decision that one rounding can flip: both
certified after the polish with the same support.  K10, the polish's
f64 CD on the support gathered on the card, against the host ``_cd64`` on
the same columns (sums in another order, in f64): x to 1e-10 relative at
equal sweeps, the same keep_idx, sweeps within one check; its kernels give
the same bits on two launches; ``polish_support``'s card and host routes
keep the same columns and certify with gaps within 1e-9.
"""

import dataclasses

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
from convex_optimization_tpu_torch.ops.bcd_sweep_slab import (
    merge_payload,
    sweep_slab_t,
    sweep_slab_t_plain,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_tiled import (
    sweep_tiled_t,
    sweep_tiled_t_plain,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    ax_minus_b_batch_t,
    ax_minus_b_batch_t_plain,
    batch_sweep_t,
    batch_sweep_t_plain,
    matvec_batch_plan,
    neg_at_r_batch_t,
    neg_at_r_batch_t_plain,
    rows_of,
)
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    ax_minus_b_t_plain,
    block_gram_t,
    block_gram_t_plain,
    block_power_gram_t,
    block_power_gram_t_plain,
    block_power_t,
    block_power_t_plain,
    neg_at_r_t,
    neg_at_r_t_plain,
    witness_gamma,
)

pytestmark = pytest.mark.cuda

#: a ragged m (m % 4 != 0: the scalar-load instances) and config 2's m
SHAPES = [(256, 1024, 32), (200, 800, 40), (10_000, 80 * 16, 80),
          (201, 800, 40), (5000, 80 * 16, 80)]
#: K2/K3's edges beside SHAPES: r in two chunks of K3 on the vector and
#: the scalar instances (K3 stages at most 28672 columns of r per CTA)
MATVEC_SHAPES = SHAPES + [(30_000, 80 * 4, 80), (28_673, 80 * 4, 80)]


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


def _matvecs_match_plain(A_t, x, b, lam2):
    """K2 and K3 against their plain versions on one A_t (any view):
    K2 to 1e-5 of ||x|| ||A||_F + max|b|, K3 to its stated rounding bound
    witness_gamma(m) ||A_j|| ||r|| per column, + 1e-6.  Returns the
    kernels' (r, z)."""
    m = A_t.shape[2]
    r = ax_minus_b_t(A_t, x, b)
    r_ref = ax_minus_b_t_plain(A_t, x, b)
    scale = float(torch.linalg.vector_norm(x)) * float(
        torch.linalg.vector_norm(A_t)) + float(b.abs().max())
    assert float((r - r_ref).abs().max()) <= 1e-5 * scale
    z = neg_at_r_t(A_t, r_ref, x, lam2)
    z_ref = neg_at_r_t_plain(A_t, r_ref, x, lam2)
    torch.cuda.synchronize()
    col = torch.linalg.vector_norm(A_t.reshape(-1, m), dim=1)
    bound = witness_gamma(m) * col * float(torch.linalg.vector_norm(r_ref))
    assert bool(((z - z_ref).abs() <= bound + 1e-6).all())
    return r, z


@pytest.mark.parametrize("m,n,B", MATVEC_SHAPES)
def test_matvec_kernels_match_plain(cuda, m, n, B):
    p, x = _data(m, n, B, cuda)
    _matvecs_match_plain(p.A_t, x, p.b, p.lam2)


@pytest.mark.parametrize("m,n,B", MATVEC_SHAPES)
def test_matvec_kernels_are_deterministic(cuda, m, n, B):
    """No atomics, a fixed summation order: two launches of K2 and of K3
    on the same inputs give the same bits."""
    p, x = _data(m, n, B, cuda)
    r = ax_minus_b_t(p.A_t, x, p.b)
    assert torch.equal(r, ax_minus_b_t(p.A_t, x, p.b))
    assert torch.equal(neg_at_r_t(p.A_t, r, x, p.lam2),
                       neg_at_r_t(p.A_t, r, x, p.lam2))


@pytest.mark.parametrize("m,n,B", [(10_000, 80 * 16, 80),
                                   (5000, 80 * 16, 80), (256, 1024, 32)])
def test_matvec_kernels_on_unaligned_views(cuda, m, n, B):
    """A_t and r as contiguous views whose data pointers are 4 bytes past
    a 16-byte boundary: the scalar-load instances run, agree with the
    plain versions, and sum in the float4 instances' order (same bits as
    on aligned copies)."""
    p, x = _data(m, n, B, cuda)
    buf = torch.empty(n * m + 1, device=cuda)
    A_u = buf[1:].view(n // B, B, m)
    A_u.copy_(p.A_t)
    assert A_u.data_ptr() % 16 != 0 and A_u.is_contiguous()
    rbuf = torch.empty(m + 1, device=cuda)
    r_al = ax_minus_b_t_plain(p.A_t, x, p.b)
    r_u = rbuf[1:]
    r_u.copy_(r_al)
    assert r_u.data_ptr() % 16 != 0
    r, _ = _matvecs_match_plain(A_u, x, p.b, p.lam2)
    assert torch.equal(r, ax_minus_b_t(p.A_t, x, p.b))
    assert torch.equal(neg_at_r_t(A_u, r_u, x, p.lam2),
                       neg_at_r_t(p.A_t, r_al, x, p.lam2))


def test_matvec_kernels_on_a_slab_view(cuda):
    """Rank 1's slab (625 x 80 x 10000) of the headline's A_t at P = 2, as
    the sharded FISTA passes it: K2 and K3 on the view against their plain
    versions, and bit for bit as on a contiguous copy."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    A_t = torch.randn(1250, 80, 10_000, generator=gen, device=cuda)
    A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
    slab = A_t[625:]
    x = torch.randn(625 * 80, generator=gen, device=cuda)
    b = torch.randn(10_000, generator=gen, device=cuda)
    r, _ = _matvecs_match_plain(slab, x, b, 0.0)
    copy = slab.clone()
    del A_t
    assert torch.equal(r, ax_minus_b_t(copy, x, b))
    assert torch.equal(neg_at_r_t(slab, r, x, 0.0),
                       neg_at_r_t(copy, r, x, 0.0))


#: K4's edges beside SHAPES: B = 200 (one 200-tile, G_j in shared
#: memory), B past the shared-memory route (300; 2000 at a small m: the
#: triangle of 128-tiles), a ragged m on both, and one block (the m
#: columns split into slices: nb = 1 at m = 100 000, and at a ragged m)
POWER_SHAPES = SHAPES + [(1000, 200 * 4, 200), (600, 300 * 3, 300),
                         (256, 2000 * 2, 2000), (1003, 200 * 3, 200),
                         (603, 300 * 2, 300), (100_000, 80, 80),
                         (40_001, 200, 200)]


@pytest.mark.parametrize("m,n,B", POWER_SHAPES)
def test_block_power_kernel_matches_plain(cuda, m, n, B):
    p, _ = _data(m, n, B, cuda)
    est = block_power_t(p.A_t)
    ref = block_power_t_plain(p.A_t)
    torch.testing.assert_close(est, ref, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("m,n,B", [(256, 1024, 32), (10_000, 80 * 16, 80),
                                   (1000, 200 * 4, 200), (600, 300 * 3, 300),
                                   (100_000, 80, 80)])
def test_block_power_kernel_is_deterministic(cuda, m, n, B):
    """No atomics, sums in a fixed order (the split-m slices added in
    slice order): two launches give the same bits."""
    p, _ = _data(m, n, B, cuda)
    assert torch.equal(block_power_t(p.A_t), block_power_t(p.A_t))


@pytest.mark.parametrize("m,n,B", [(10_000, 80 * 16, 80),
                                   (1000, 200 * 4, 200), (600, 300 * 3, 300)])
def test_block_power_kernel_on_an_unaligned_view(cuda, m, n, B):
    """A_t as a contiguous view 4 bytes past a 16-byte boundary: the 4-byte
    copies run and agree with the plain version."""
    p, _ = _data(m, n, B, cuda)
    buf = torch.empty(n * m + 1, device=cuda)
    A_u = buf[1:].view(n // B, B, m)
    A_u.copy_(p.A_t)
    assert A_u.data_ptr() % 16 != 0 and A_u.is_contiguous()
    torch.testing.assert_close(block_power_t(A_u),
                               block_power_t_plain(p.A_t), rtol=1e-4,
                               atol=0.0)


@pytest.mark.parametrize("m,B", [(1000, 80), (1000, 200), (603, 300)])
def test_block_power_kernel_zero_and_rank_one_blocks(cuda, m, B):
    """An all-zero block gives 0 (the 1e-30 clamps; no NaN), and a block
    whose B rows all equal one m-vector a gives 1.02 B ||a||^2 (its Gram
    is ||a||^2 times the all-ones matrix) within 1e-5 relative; a random
    block beside them still matches the plain version."""
    rng = np.random.default_rng(B)
    a = rng.standard_normal(m).astype(np.float32)
    A_t = np.zeros((3, B, m), np.float32)
    A_t[1] = a
    A_t[2] = rng.standard_normal((B, m)).astype(np.float32) / np.sqrt(m)
    A_t = torch.as_tensor(A_t, device=cuda)
    est = block_power_t(A_t)
    assert float(est[0]) == 0.0
    want = 1.02 * B * float(np.dot(a.astype(np.float64), a))
    assert abs(float(est[1]) - want) <= 1e-5 * want
    torch.testing.assert_close(est[2], block_power_t_plain(A_t[2:])[0],
                               rtol=1e-4, atol=0.0)


#: K4's two stages: the smem and global routes, a split m, a ragged m
STAGE_SHAPES = [(256, 1024, 32), (10_000, 80 * 16, 80),
                (1000, 200 * 4, 200), (600, 300 * 3, 300),
                (100_000, 80, 80), (1003, 200 * 3, 200)]


@pytest.mark.parametrize("m,n,B", STAGE_SHAPES)
def test_block_power_stages_match_plain(cuda, m, n, B):
    """K4's Gram stage against ``bmm`` (1e-5 of each G_j's diagonal scale,
    exactly symmetric) and its iteration stage on that G against the plain
    iteration (1e-4 relative); each launched twice gives the same bits,
    and each wrapper counts one launch."""
    p, _ = _data(m, n, B, cuda)
    before = dict(_build.launches)
    G = block_gram_t(p.A_t)
    scale = torch.diagonal(G, dim1=1, dim2=2).amax(dim=1)[:, None, None]
    err = (G - block_gram_t_plain(p.A_t)).abs() / scale
    assert float(err.max()) <= 1e-5
    assert torch.equal(G, G.transpose(1, 2))
    assert torch.equal(G, block_gram_t(p.A_t))
    est = block_power_gram_t(G)
    torch.testing.assert_close(est, block_power_gram_t_plain(G), rtol=1e-4,
                               atol=0.0)
    assert torch.equal(est, block_power_gram_t(G))
    for name in ("block_gram_t", "block_power_gram_t"):
        assert _build.launches[name] == before.get(name, 0) + 2


@pytest.mark.parametrize("m,n,B", STAGE_SHAPES)
def test_block_power_stages_compose_to_block_power_t(cuda, m, n, B):
    """The two stages in turn launch ``block_power_t``'s kernels in its
    order (one chunk at these shapes): the same bits.  The Grams of two
    row halves summed, then iterated, equal ``block_power_t`` on the
    whole A_t to 1e-4 relative (the row-sharded set-up)."""
    p, _ = _data(m, n, B, cuda)
    whole = block_power_t(p.A_t)
    assert torch.equal(block_power_gram_t(block_gram_t(p.A_t)), whole)
    h = m // 2
    G = (block_gram_t(p.A_t[..., :h].contiguous())
         + block_gram_t(p.A_t[..., h:].contiguous()))
    torch.testing.assert_close(block_power_gram_t(G), whole, rtol=1e-4,
                               atol=0.0)


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


#: K9 on a 132-SM card at small shapes, whose whole slab the ring keeps
#: (one chunk, kept: phase 2 copies nothing); at one K1 refuses (a 2000 x
#: 32 tile: 256 KB; 5 chunks of 455, 2 kept, the last 180 coordinates);
#: config 4's plan on 4 blocks (20 chunks of 105, 2 kept, the last 5);
#: m % 4 != 0 (the scalar instance: 4 chunks of 21, 2 kept, the last 17);
#: a 16-block slice of the tall shape (B = 80, m = 100 000: the same
#: chunks, float4).  tests/test_torch_tiled.py holds these plans.
TILED_SHAPES = [(256, 1024, 32), (200, 800, 40), (4096, 2000 * 4, 2000),
                (20_000, 2000 * 4, 2000), (100_003, 80 * 4, 80),
                (100_000, 80 * 16, 80)]


def _group_penalty(n, B, device, seed=3):
    """group_l2 with groups of B / 4 (every block holds whole groups) and
    random weights."""
    ngroups = 4 * n // B
    w = np.random.default_rng(seed).uniform(0.5, 2.0, ngroups)
    return Penalty(lam1=0.05, kind="group_l2", ngroups=ngroups,
                   weights=torch.as_tensor(w, dtype=torch.float32,
                                           device=device))


def _one_sweep(sweep, plain, p, x, pen, mask):
    """One sweep of the kernel and of its plain version from (x, A x - b);
    both must agree to 1e-5 and keep masked coordinates at 0."""
    r = ax_minus_b_t_plain(p.A_t, x, p.b)
    steps = block_steps(block_power_t_plain(p.A_t), p.lam2, 0.5)
    x_k, r_k = sweep(p.A_t, x, r, steps, mask, pen, p.lam2)
    x_p, r_p = plain(p.A_t, x, r, steps, mask, pen, p.lam2)
    xs = max(1.0, float(x_p.abs().max()))
    assert float((x_k - x_p).abs().max()) <= 1e-5 * xs
    assert float(torch.linalg.vector_norm(r_k - r_p)) <= \
        1e-5 * float(torch.linalg.vector_norm(r_p))
    assert float((x_p - x).abs().max()) > 0
    if mask is not None:
        assert bool((x_k[~mask] == 0).all())


@pytest.mark.parametrize("m,n,B", SHAPES)
def test_group_sweep_kernel_matches_plain(cuda, m, n, B):
    p, x = _data(m, n, B, cuda)
    mask = torch.rand(n, generator=torch.Generator().manual_seed(1)) > 0.05
    _one_sweep(sweep_t, sweep_t_plain, p, x,
               _group_penalty(n, B, cuda), mask.to(cuda))


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", TILED_SHAPES)
def test_tiled_sweep_kernel_matches_plain(cuda, m, n, B, kind):
    p, x = _data(m, n, B, cuda)
    pen = (_group_penalty(n, B, cuda) if kind == "group_l2"
           else Penalty(lam1=0.05, kind=kind))
    if kind == "nonneg_l1":
        x = x.abs()
    mask = torch.rand(n, generator=torch.Generator().manual_seed(2)) > 0.05
    _one_sweep(sweep_tiled_t, sweep_tiled_t_plain, p, x, pen, mask.to(cuda))
    _one_sweep(sweep_tiled_t, sweep_tiled_t_plain, p, x, pen, None)


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", [(256, 1024, 32), (4096, 2000 * 4, 2000),
                                   (20_000, 2000 * 4, 2000)])
def test_tiled_sweep_kernel_is_deterministic(cuda, m, n, B, kind):
    """No float atomics, a fixed summation order: two launches of K9 on the
    same inputs give the same bits, masked and not."""
    p, x = _data(m, n, B, cuda)
    pen, x, r, steps, mask = _sweep_inputs(p, x, kind, cuda)
    for keep in (mask, None):
        args = (p.A_t, x, r, steps, keep, pen, p.lam2)
        x1, r1 = sweep_tiled_t(*args)
        x2, r2 = sweep_tiled_t(*args)
        assert torch.equal(x1, x2) and torch.equal(r1, r2)


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", [(4096, 2000 * 4, 2000),
                                   (100_000, 80 * 4, 80)])
def test_tiled_sweep_kernel_on_an_unaligned_view(cuda, m, n, B, kind):
    """A contiguous A_t view 4 bytes past a 16-byte boundary takes K9's
    scalar instance (each run 1 float into its row) and matches the plain
    version, masked and not, with the same bits on two launches."""
    p, x = _data(m, n, B, cuda)
    pen = (_group_penalty(n, B, cuda) if kind == "group_l2"
           else Penalty(lam1=0.05, kind=kind))
    if kind == "nonneg_l1":
        x = x.abs()
    buf = torch.empty(p.A_t.numel() + 1, device=cuda)
    A_u = buf[1:].view(p.A_t.shape)
    A_u.copy_(p.A_t)
    assert A_u.is_contiguous() and A_u.data_ptr() % 16 != 0
    p_u = dataclasses.replace(p, A_t=A_u)
    mask = torch.rand(n, generator=torch.Generator().manual_seed(4)) > 0.05
    for keep in (mask.to(cuda), None):
        _one_sweep(sweep_tiled_t, sweep_tiled_t_plain, p_u, x, pen, keep)
        r = ax_minus_b_t_plain(A_u, x, p.b)
        steps = block_steps(block_power_t_plain(A_u), p.lam2, 0.5)
        args = (A_u, x, r, steps, keep, pen, p.lam2)
        out1, out2 = sweep_tiled_t(*args), sweep_tiled_t(*args)
        assert all(torch.equal(a, b) for a, b in zip(out1, out2))


def _sweep_inputs(p, x, kind, cuda, seed=1):
    """(penalty, x, r = A x - b, steps, a partly-zero keep mask) for one
    K1 / K8 sweep at ``kind``."""
    nb, B, m = p.A_t.shape
    pen = (_group_penalty(nb * B, B, cuda) if kind == "group_l2"
           else Penalty(lam1=0.05, kind=kind))
    if kind == "nonneg_l1":
        x = x.abs()
    r = ax_minus_b_t_plain(p.A_t, x, p.b)
    steps = block_steps(block_power_t_plain(p.A_t), p.lam2, 0.5)
    mask = torch.rand(nb * B, generator=torch.Generator().manual_seed(seed))
    return pen, x, r, steps, (mask > 0.05).to(cuda)


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_sweep_kernel_is_deterministic(cuda, m, n, B, kind):
    """No float atomics, a fixed summation order: two launches of K1, and
    of K8, on the same inputs give the same bits."""
    p, x = _data(m, n, B, cuda)
    pen, x, r, steps, mask = _sweep_inputs(p, x, kind, cuda)
    for keep in (mask, None):
        args = (p.A_t, x, r, steps, keep, pen, p.lam2)
        x1, r1 = sweep_t(*args)
        x2, r2 = sweep_t(*args)
        assert torch.equal(x1, x2) and torch.equal(r1, r2)
        out1, out2 = sweep_slab_t(*args), sweep_slab_t(*args)
        assert all(torch.equal(a, b) for a, b in zip(out1, out2))


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", [(256, 1024, 32), (10_000, 80 * 16, 80),
                                   (20_000, 200 * 2, 200)])
def test_sweep_kernel_on_an_unaligned_view(cuda, m, n, B, kind):
    """A contiguous A_t view 4 bytes past a 16-byte boundary takes the
    4-byte copies (the aligned copy: 16-byte ones) and gives the bits of
    the aligned copy, in K1 and K8; at m = 20 000 with a partial
    prefetch."""
    p, x = _data(m, n, B, cuda)
    pen, x, r, steps, mask = _sweep_inputs(p, x, kind, cuda)
    buf = torch.empty(p.A_t.numel() + 1, device=cuda)
    A_u = buf[1:].view(p.A_t.shape)
    A_u.copy_(p.A_t)
    assert A_u.is_contiguous() and A_u.data_ptr() % 16 != 0
    for sweep in (sweep_t, sweep_slab_t):
        out_u = sweep(A_u, x, r, steps, mask, pen, p.lam2)
        out_a = sweep(p.A_t, x, r, steps, mask, pen, p.lam2)
        assert all(torch.equal(a, b) for a, b in zip(out_u, out_a))


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
def test_sweep_kernel_at_config4_group_widths(cuda, kind):
    """Config 4's K1 tile (B = 200, m = 20 000), whose plan prefetches only
    part of the next tile, against the plain version over 6 blocks, masked
    and not; group_l2 over groups of 200 with weights."""
    from convex_optimization_tpu_torch.ops.bcd_sweep import sweep_plan

    m, B = 20_000, 200
    p, x = _data(m, 6 * B, B, cuda)
    plan = sweep_plan(cuda, B, m)
    assert 0 < plan.prefetch < B
    if kind == "group_l2":
        w = np.random.default_rng(5).uniform(0.5, 1.5, 6)
        pen = Penalty(lam1=0.05, kind="group_l2", ngroups=6,
                      weights=torch.as_tensor(w, dtype=torch.float32,
                                              device=cuda))
    else:
        pen = Penalty(lam1=0.05, kind="l1")
    mask = torch.rand(6 * B, generator=torch.Generator().manual_seed(3))
    for keep in ((mask > 0.05).to(cuda), None):
        _one_sweep(sweep_t, sweep_t_plain, p, x, pen, keep)


def test_k1_refuses_the_tile_k9_takes(cuda):
    p, x = _data(4096, 2000 * 4, 2000, cuda)
    pen = Penalty(lam1=0.05, kind="l1")
    steps = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sweep_t(p.A_t, x, -p.b, steps, None, pen, 0.0)
    sweep_tiled_t(p.A_t, x, -p.b, steps, None, pen, 0.0)


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


#: K6/K7's edges beside SHAPES: a ragged m (the scalar-load instances)
#: with 13 blocks, and a ragged m longer than one of K7's R chunks (at
#: most 2560 columns, so m = 10_000 takes several on the vector instances)
BATCH_MV_SHAPES = SHAPES + [(1001, 80 * 13, 80), (6001, 80 * 7, 80)]
BATCH_MV_LS = [1, 3, 5, 10, 16]


def test_batch_matvec_plan_reaches_the_edges(cuda):
    """The shapes of the K6/K7 tests cover what the plan makes of them:
    slices that do not split n evenly, and K7 with more than one R chunk
    on both the vector and the scalar instances."""
    uneven = multi_vec = multi_scalar = False
    for m, n, B in BATCH_MV_SHAPES:
        for L in BATCH_MV_LS:
            S, W, C, _ = matvec_batch_plan(cuda, n, m, L)
            uneven |= n % S != 0
            assert W % 128 == 0 and W * C >= m > W * (C - 1)
            multi_vec |= C > 1 and m % 4 == 0
            multi_scalar |= C > 1 and m % 4 != 0
    assert uneven and multi_vec and multi_scalar


@pytest.mark.parametrize("L", BATCH_MV_LS)
@pytest.mark.parametrize("m,n,B", BATCH_MV_SHAPES)
def test_batch_matvec_kernels_match_plain(cuda, m, n, B, L):
    p, _ = _data(m, n, B, cuda)
    X, R, _, _, _, _ = _batch(p, L)
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


@pytest.mark.parametrize("L", [3, 16])
@pytest.mark.parametrize("m,n,B", [(10_000, 80 * 16, 80),
                                   (6001, 80 * 7, 80)])
def test_batch_matvec_kernels_are_deterministic(cuda, m, n, B, L):
    """No atomics, fixed summation order: two launches on the same inputs
    give the same bits."""
    p, _ = _data(m, n, B, cuda)
    X, R, _, _, _, _ = _batch(p, L)
    assert torch.equal(ax_minus_b_batch_t(p.A_t, X, p.b),
                       ax_minus_b_batch_t(p.A_t, X, p.b))
    assert torch.equal(neg_at_r_batch_t(p.A_t, R, X, p.lam2),
                       neg_at_r_batch_t(p.A_t, R, X, p.lam2))


def _batch_penalty(kind, n, B, device):
    """K5's penalty: lam1 1 (the kernel reads lam1s), group_l2 as
    ``_group_penalty`` (whole groups in every block, random weights)."""
    if kind == "group_l2":
        return dataclasses.replace(_group_penalty(n, B, device), lam1=1.0)
    return Penalty(lam1=1.0, kind=kind)


@pytest.mark.parametrize("L", [3, 4, 16])
@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_batch_sweep_kernel_matches_plain(cuda, m, n, B, kind, L):
    p, _ = _data(m, n, B, cuda)
    X, R, keep, _, lam1s, steps = _batch(p, L)
    pen = _batch_penalty(kind, n, B, cuda)
    if kind == "nonneg_l1":
        X = X.abs()
        R = ax_minus_b_batch_t_plain(p.A_t, X, p.b)
    X_k, R_k = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep)
    X_p, R_p = batch_sweep_t_plain(p.A_t, X, R, steps, lam1s, p.lam2, pen,
                                   keep)
    _sweeps_close(X_k, R_k, X_p, R_p)
    assert bool((rows_of(X_k)[:, ~keep] == 0).all())


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_masked_batch_sweep_kernel_is_exact_vs_masked_copy(cuda, m, n, B,
                                                           kind):
    p, _ = _data(m, n, B, cuda)
    X, R, keep, rm, lam1s, steps = _batch(p, 3)
    R = rm * R                      # residual rows come in masked
    pen = _batch_penalty(kind, n, B, cuda)
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


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_batch_sweep_kernel_is_deterministic(cuda, m, n, B, kind):
    """No float atomics, a fixed summation order: two launches of K5 on the
    same inputs give the same bits, masked or not."""
    p, _ = _data(m, n, B, cuda)
    X, R, keep, rm, lam1s, steps = _batch(p, 10)
    pen = _batch_penalty(kind, n, B, cuda)
    for masks in ((keep, None), (keep, rm)):
        X1, R1 = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, *masks)
        X2, R2 = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, *masks)
        assert torch.equal(X1, X2) and torch.equal(R1, R2)


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", [(256, 1024, 32), (5000, 80 * 16, 80)])
def test_batch_sweep_kernel_on_an_unaligned_view(cuda, m, n, B, kind):
    """A contiguous A_t view 4 bytes past a 16-byte boundary takes the
    4-byte copies and gives the bits of the aligned copy."""
    p, _ = _data(m, n, B, cuda)
    X, R, keep, rm, lam1s, steps = _batch(p, 4)
    pen = _batch_penalty(kind, n, B, cuda)
    buf = torch.empty(p.A_t.numel() + 1, device=cuda)
    A_u = buf[1:].view(p.A_t.shape)
    A_u.copy_(p.A_t)
    assert A_u.is_contiguous() and A_u.data_ptr() % 16 != 0
    for masks in ((keep, None), (keep, rm)):
        X1, R1 = batch_sweep_t(A_u, X, R, steps, lam1s, p.lam2, pen, *masks)
        X2, R2 = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen,
                               *masks)
        assert torch.equal(X1, X2) and torch.equal(R1, R2)


def test_batch_sweep_kernel_at_config4_group_widths(cuda):
    """Config 4's group tile (B = 200, m = 20 000, groups of 200, L = 10),
    whose plan prefetches only part of the next tile, against the plain
    version over 4 blocks, masked and not."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan

    m, B, gsize = 20_000, 200, 200
    p, _ = _data(m, 4 * B, B, cuda)
    plan = batch_plan(cuda, B, m, 10, gsize)
    assert 0 < plan.prefetch < B
    X, R, keep, rm, lam1s, steps = _batch(p, 10)
    w = np.random.default_rng(5).uniform(0.5, 1.5, 4 * B // gsize)
    pen = Penalty(lam1=1.0, kind="group_l2", ngroups=4 * B // gsize,
                  weights=torch.as_tensor(w, dtype=torch.float32,
                                          device=cuda))
    for masks, R_in in (((keep, None), R), ((keep, rm), rm * R)):
        X_k, R_k = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                                 *masks)
        X_p, R_p = batch_sweep_t_plain(p.A_t, X, R_in, steps, lam1s, p.lam2,
                                       pen, *masks)
        _sweeps_close(X_k, R_k, X_p, R_p)
        assert bool((rows_of(X_k)[:, ~keep] == 0).all())


def test_batch_sweep_kernel_at_config2_shape(cuda):
    """Config 2's shape (m = 5000, B = 80, L = 10, l1) over 16 blocks, as
    the batched path launches it (its plan: clusters of the card's own
    occupancy), against the plain version, masked and not."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan

    p, _ = _data(5000, 16 * 80, 80, cuda)
    plan = batch_plan(cuda, 80, 5000, 10)
    assert plan.cs > 1 and plan.nc > 1
    X, R, keep, rm, lam1s, steps = _batch(p, 10)
    pen = _batch_penalty("l1", 16 * 80, 80, cuda)
    for masks, R_in in (((None, None), R), ((keep, rm), rm * R)):
        X_k, R_k = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                                 *masks)
        X_p, R_p = batch_sweep_t_plain(p.A_t, X, R_in, steps, lam1s, p.lam2,
                                       pen, *masks)
        _sweeps_close(X_k, R_k, X_p, R_p)


@pytest.mark.parametrize("kind", ["l1", "group_l2"])
@pytest.mark.parametrize("m", [1000, 201])
def test_batch_sweep_kernel_with_ctas_without_rows(cuda, m, kind):
    """Shapes whose last cluster holds CTAs without rows (their partials
    are zeros; the float4 and the scalar instance) against the plain
    version, and two launches the same bits."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan

    B, L = 40, 5
    n = 8 * B
    p, _ = _data(m, n, B, cuda)
    plan = batch_plan(cuda, B, m, L, B // 4 if kind == "group_l2" else 0)
    assert plan.grid * plan.rows - m >= plan.rows      # a CTA without rows
    X, R, keep, _, lam1s, steps = _batch(p, L)
    pen = _batch_penalty(kind, n, B, cuda)
    X_k, R_k = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep)
    X_p, R_p = batch_sweep_t_plain(p.A_t, X, R, steps, lam1s, p.lam2, pen,
                                   keep)
    _sweeps_close(X_k, R_k, X_p, R_p)
    X2, R2 = batch_sweep_t(p.A_t, X, R, steps, lam1s, p.lam2, pen, keep)
    assert torch.equal(X_k, X2) and torch.equal(R_k, R2)


def test_batch_sweep_kernel_is_deterministic_across_clusters(cuda):
    """Many clusters (config 2's rows, 64 blocks, L = 16): two launches give
    the same bits, with and without the row mask."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan

    p, _ = _data(5000, 64 * 80, 80, cuda)
    assert batch_plan(cuda, 80, 5000, 16).nc > 1
    X, R, keep, rm, lam1s, steps = _batch(p, 16)
    pen = _batch_penalty("l1", 64 * 80, 80, cuda)
    for masks, R_in in (((keep, None), R), ((keep, rm), rm * R)):
        X1, R1 = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                               *masks)
        X2, R2 = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                               *masks)
        assert torch.equal(X1, X2) and torch.equal(R1, R2)


@pytest.mark.parametrize("m,B,kind", [(12_148, 400, "group_l2"),
                                      (15_709, 400, "l1"),
                                      (30_100, 200, "group_l2")])
def test_batch_sweep_kernel_in_clusters_of_one(cuda, m, B, kind):
    """Tiles near the shared-memory limit, whose plan takes clusters of one
    CTA (the float4 instance, the scalar one, and bulk copies), against
    the plain version, and two launches the same bits, masked and not."""
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan

    L, n = 10, 3 * B
    p, _ = _data(m, n, B, cuda)
    gsize = B // 4 if kind == "group_l2" else 0
    assert batch_plan(cuda, B, m, L, gsize).cs == 1
    X, R, keep, rm, lam1s, steps = _batch(p, L)
    pen = _batch_penalty(kind, n, B, cuda)
    for masks, R_in in (((keep, None), R), ((keep, rm), rm * R)):
        X_k, R_k = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                                 *masks)
        X_p, R_p = batch_sweep_t_plain(p.A_t, X, R_in, steps, lam1s, p.lam2,
                                       pen, *masks)
        _sweeps_close(X_k, R_k, X_p, R_p)
        X2, R2 = batch_sweep_t(p.A_t, X, R_in, steps, lam1s, p.lam2, pen,
                               *masks)
        assert torch.equal(X_k, X2) and torch.equal(R_k, R2)


def test_batched_path_setup_span_carries_the_k5_plan(cuda):
    """The batched path's set-up span names the exchange its sweeps ran
    with: the K5 plan's cluster size, cluster count and grid."""
    from torch.profiler import ProfilerActivity, profile

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops.bcd_sweep import (
        pick_block_size_t,
    )
    from convex_optimization_tpu_torch.ops.bcd_sweep_batch import batch_plan
    from convex_optimization_tpu_torch.solvers.common import SolverConfig
    from convex_optimization_tpu_torch.utils.trace import RECORDER

    inst, _, _ = make_lasso_instance_host(4, 300, 1200, device=cuda)
    cfg = SolverConfig(tol=1e-5, max_iters=200, gap_every=10)
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cot.lambda_path(inst.problem, cfg, path_len=4, method="bcd_batch")
    attrs = [r["attrs"] for r in RECORDER.records(RECORDER.session)
             if r["name"] == "cot.setup" and "k5_cs" in r["attrs"]]
    RECORDER.clear()
    plan = batch_plan(cuda, pick_block_size_t(1200, 128)[0], 300, 4)
    assert attrs == [{"k5_cs": plan.cs, "k5_nc": plan.nc,
                      "k5_grid": plan.grid}]


def test_batched_path_on_card_matches_cpu(cuda):
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    inst_c, _, _ = make_lasso_instance_host(3, 64, 256, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(3, 64, 256, device="cpu")
    before = dict(_build.launches)
    res_c = cot.lambda_path(inst_c.problem, cfg, path_len=6,
                            method="bcd_batch")
    res_h = cot.lambda_path(inst_h.problem, cfg, path_len=6,
                            method="bcd_batch")
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
    sweep_t(p.A_t, x, -p.b, steps, None, Penalty(0.05), 0.0)
    sweep_tiled_t(p.A_t, x, -p.b, steps, None, Penalty(0.05), 0.0)
    sweep_slab_t(p.A_t, x, -p.b, steps, None, Penalty(0.05), 0.0)
    for name in ("ax_minus_b_t", "neg_at_r_t", "block_power_t",
                 "batch_sweep_t", "ax_minus_b_batch_t", "neg_at_r_batch_t",
                 "sweep_t", "sweep_tiled_t", "sweep_slab_t"):
        assert _build.launches[name] == before.get(name, 0) + 1


def test_wrappers_reject_bad_operands(cuda):
    p, x = _data(256, 1024, 32, cuda)
    with pytest.raises(ValueError):
        ax_minus_b_t(p.A_t, x.double(), p.b)
    with pytest.raises(ValueError):
        neg_at_r_t(p.A_t, p.b.cpu(), x, 0.0)
    group = Penalty(lam1=0.05, kind="group_l2", ngroups=32)
    split = Penalty(lam1=0.05, kind="group_l2", ngroups=16)
    # K1 (and K9) and K5 take group_l2 where a block holds whole groups
    sweep_t(p.A_t, x, -p.b, torch.ones(32, device=cuda), None, group, 0.0)
    with pytest.raises(ValueError, match="whole groups"):
        sweep_t(p.A_t, x, -p.b, torch.ones(32, device=cuda), None, split,
                0.0)
    X, R, _, _, lam1s, steps = _batch(p, 2)
    batch_sweep_t(p.A_t, X, R, steps, lam1s, 0.0, group)
    with pytest.raises(ValueError, match="whole groups"):
        batch_sweep_t(p.A_t, X, R, steps, lam1s, 0.0, split)
    with pytest.raises(ValueError, match="unknown penalty kind"):
        batch_sweep_t(p.A_t, X, R, steps, lam1s, 0.0,
                      Penalty(lam1=1.0, kind="nope"))
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
    inst_h, _, _ = make_lasso_instance_host(0, 200, 800, device="cpu")
    res_c = cot.solve(inst_c.problem, "bcd_pallas", **kw)
    res_h = cot.solve(inst_h.problem, "bcd_pallas", **kw)
    assert abs(res_c.iterations - res_h.iterations) <= 10
    pr = cot.polish_support(inst_c.problem, res_c.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert pr.rel_gap <= 1e-6


@pytest.mark.parametrize("block_size,kernel", [(200, "sweep_t"),
                                               (2000, "sweep_tiled_t")])
def test_group_solve_on_card_routes_and_certifies(cuda, block_size, kernel):
    """A group lasso (20 groups of 200) solved on the card through K1
    (B = 200) or K9 (B = 2000, a tile K1 refuses), then the group polish:
    the routed kernel ran, the other did not, and f64 certifies 1e-6."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    inst, A, b = make_lasso_instance_host(
        4, 4096, 4000, penalty_kind="group_l2", ngroups=20, device=cuda)
    _build.reset_launches()
    res = cot.solve(inst.problem, "bcd_pallas", block_size=block_size,
                    tol=1e-6, gap_every=10, stall_checks=15)
    other = "sweep_t" if kernel == "sweep_tiled_t" else "sweep_tiled_t"
    assert _build.launches[kernel] == res.iterations > 0
    assert _build.launches[other] == 0
    pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                            b_host=b)
    assert pr.rel_gap <= 1e-6


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("m,n,B", SHAPES)
def test_slab_sweep_kernel_matches_plain(cuda, m, n, B, kind):
    """K8 against its plain version, one sweep from a nonzero start with
    a partly-zero mask: x and r as K1, the payload's dr against the
    plain dr, its scalars against the merge's expressions on K8's own x
    and r."""
    p, x = _data(m, n, B, cuda)
    pen = (_group_penalty(n, B, cuda) if kind == "group_l2"
           else Penalty(lam1=0.05, kind=kind))
    if kind == "nonneg_l1":
        x = x.abs()
    mask = torch.rand(n, generator=torch.Generator().manual_seed(4)) > 0.05
    mask = mask.to(cuda)
    r = ax_minus_b_t_plain(p.A_t, x, p.b)
    steps = block_steps(block_power_t_plain(p.A_t), p.lam2, 0.5)
    x_k, r_k, pay_k = sweep_slab_t(p.A_t, x, r, steps, mask, pen, p.lam2)
    x_p, r_p, pay_p = sweep_slab_t_plain(p.A_t, x, r, steps, mask, pen,
                                         p.lam2)
    xs = max(1.0, float(x_p.abs().max()))
    rn = float(torch.linalg.vector_norm(r_p))
    assert float((x_k - x_p).abs().max()) <= 1e-5 * xs
    assert float(torch.linalg.vector_norm(r_k - r_p)) <= 1e-5 * rn
    assert float(torch.linalg.vector_norm(pay_k[:m] - pay_p[:m])) <= \
        1e-5 * rn
    assert bool((x_k[~mask] == 0).all())
    want = merge_payload(x, x_k, r, r_k, pen)
    dx = x_k - x
    scale = torch.stack([(x * dx).abs().sum(), (dx * dx).sum(),
                         float(pen.lam1) * dx.abs().sum() * (
                             1.0 if pen.weights is None
                             else float(pen.weights.max()))])
    assert bool(((pay_k[m:] - want[m:]).abs() <= 1e-4 * scale).all())
    assert float(scale[1]) > 0


def _k8_equals_k1(A_t, x, r, steps, keep, pen):
    """K8 and K1 on the same slab and operands: x and r bit for bit."""
    x8, r8, _ = sweep_slab_t(A_t, x, r, steps, keep, pen, 0.0)
    x1, r1 = sweep_t(A_t, x, r, steps, keep, pen, 0.0)
    assert torch.equal(x8, x1) and torch.equal(r8, r1)
    assert float((x8 - x).abs().max()) > 0


@pytest.mark.parametrize("where", ["rank_slab", "unaligned_view",
                                   "config4_group"])
def test_slab_kernel_equals_k1_on_the_same_slab(cuda, where):
    """K8 is K1's payload instance on K1's plan, so its x and r are K1's
    bit for bit: on rank 1's slab (625 x 80 x 10000, a view) of a
    headline-shaped A_t at P = 2, on that slab as a view 4 bytes past a
    16-byte boundary (4-byte copies), and at config 4's group tile (B =
    200, m = 20 000, weighted group_l2 over groups of 200, a partial
    prefetch) with a partly-zero mask."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    if where == "config4_group":
        m, B, nb = 20_000, 200, 6
        A_t = torch.randn(nb, B, m, generator=gen, device=cuda)
        w = 0.5 + torch.rand(nb, generator=gen, device=cuda)
        pen = Penalty(lam1=0.05, kind="group_l2", ngroups=nb, weights=w)
        keep = torch.rand(nb * B, generator=gen, device=cuda) > 0.05
    else:
        m, B, nb = 10_000, 80, 625
        A_t = torch.randn(2 * nb, B, m, generator=gen, device=cuda)[nb:]
        pen, keep = Penalty(lam1=0.05, kind="l1"), None
    A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
    if where == "unaligned_view":
        buf = torch.empty(A_t.numel() + 1, device=cuda)
        A_u = buf[1:].view(A_t.shape)
        A_u.copy_(A_t)
        del A_t
        A_t = A_u
        assert A_t.is_contiguous() and A_t.data_ptr() % 16 != 0
    x = torch.randn(nb * B, generator=gen, device=cuda)
    x = torch.where(torch.rand(nb * B, generator=gen, device=cuda) < 0.1,
                    x, torch.zeros_like(x))
    b = torch.randn(m, generator=gen, device=cuda)
    r = ax_minus_b_t_plain(A_t, x, b)
    steps = block_steps(block_power_t_plain(A_t), 0.0, 0.5)
    _k8_equals_k1(A_t, x, r, steps, keep, pen)


def test_slab_kernel_refuses_the_tile_k9_takes(cuda):
    p, x = _data(4096, 2000 * 4, 2000, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sweep_slab_t(p.A_t, x, -p.b, torch.ones(4, device=cuda), None,
                     Penalty(lam1=0.05, kind="l1"), 0.0)


def test_sharded_solves_on_card_match_cpu(cuda, tmp_path):
    """Two gloo ranks sharing the card run sharded BCD (K8) and FISTA
    through solve(mesh=...); the same on two CPU ranks (plain versions):
    step counts within one check, x close, K8 launched in each card rank
    and K1 in none."""
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.parallel.launch import run_ranks
    from test_torch_sharded_ranks import solve_job

    inst, A, b = make_lasso_instance_host(6, 200, 800, device="cpu")
    pen = dict(penalty_kind="l1", lam1=float(inst.problem.penalty.lam1))
    runs = [dict(method="bcd_pallas", api=True,
                 cfg=dict(tol=1e-6, max_iters=4000, gap_every=10,
                          stall_checks=15, block_size=40)),
            dict(method="fista", api=True,
                 cfg=dict(tol=1e-5, max_iters=4000, gap_every=10,
                          stall_checks=15))]
    card = run_ranks(solve_job, 2, tmp_path / "card", A, b, pen, runs,
                     device="cuda:0", backend="gloo", timeout_s=300)
    host = run_ranks(solve_job, 2, tmp_path / "cpu", A, b, pen, runs,
                     device="cpu", backend="gloo", timeout_s=300)
    for rank in range(2):
        assert card[rank][0]["launches"].get("sweep_slab_t", 0) > 0
        assert card[rank][0]["launches"].get("sweep_t", 0) == 0
    for c, h in zip(card[0], host[0]):
        assert abs(c["k"] - h["k"]) <= 10
        np.testing.assert_allclose(c["x"], h["x"], atol=5e-4)


def test_sharded_paths_on_card_match_cpu(cuda, tmp_path):
    """The sharded paths on the card: two gloo ranks sharing it run the
    screened sharded BCD and the sequential (bcd_pallas, fista) and
    batched sharded paths of chip_smoke's phase 17 on its small instance
    (l1 and weighted group_l2); the same on two CPU ranks.  Each card run
    is held to the CPU run by ``chip_smoke.path_check``, every path point
    on its own, and K8 (BCD), K2/K3 (FISTA) and K5-K7 (batched) launched
    in each card rank."""
    import os
    import sys

    from convex_optimization_tpu_torch.parallel.launch import run_ranks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    from test_torch_sharded_ranks import path_job, solve_job

    A, b, pens = cs.shard_small_instance()
    runs = {"card": {}, "cpu": {}}
    for where, dev in (("card", "cuda:0"), ("cpu", "cpu")):
        for kind, pen in pens.items():
            screened = dict(method="bcd_pallas", api=True,
                            cfg=cs.SHARD_SCREEN)
            paths = [dict(pen=pen, cfg=kw,
                          kw=dict(cs.SMALL_GRID, method=method))
                     for method, kw in cs.SMALL_PATHS]
            out = run_ranks(solve_job, 2, tmp_path / f"{where}{kind}s", A,
                            b, pen, [screened], device=dev, backend="gloo",
                            timeout_s=600)
            runs[where][kind] = (out, run_ranks(
                path_job, 2, tmp_path / f"{where}{kind}p", A, b, paths,
                device=dev, backend="gloo", timeout_s=600))
    for kind, pen in pens.items():
        p = problem_from_numpy(A, b, device="cpu", **pen)
        (cs_card, cp_card), (cs_cpu, cp_cpu) = (runs[w][kind]
                                                for w in ("card", "cpu"))
        for rank in range(2):
            lc = cs_card[rank][0]["launches"]
            assert lc.get("sweep_slab_t", 0) > 0 and lc.get("sweep_t", 0) == 0
        card, cpu = (dict(r[0][0], primal=r[0][0]["history"]["primal"],
                          rel_gap=r[0][0]["history"]["rel_gap"])
                     for r in (cs_card, cs_cpu))
        a, h = (cs.path_run(p, r, A, b, 1e-6) for r in (card, cpu))
        assert not cs.path_check(a, h, cs.SHARD_SCREEN["tol"],
                                 cs.SHARD_SCREEN["gap_every"])
        for i, (method, kw) in enumerate(cs.SMALL_PATHS):
            pc, ph = cp_card[0][i], cp_cpu[0][i]
            assert pc["method_used"] == ph["method_used"] \
                == f"{method}+sharded"
            want = {"bcd_pallas": "sweep_slab_t", "fista": "neg_at_r_t",
                    "bcd_batch": "batch_sweep_t"}[method]
            for rank in range(2):
                assert cp_card[rank][i]["launches"].get(want, 0) > 0
            for l, lam in enumerate(pc["lambdas"]):
                run = [dict(x=r["xs"][l], primal=hist["primal"],
                            rel_gap=hist["rel_gap"],
                            converged=bool(r["converged"][l]))
                       for r, hist in ((pc, pc["histories"][l]),
                                       (ph, ph["histories"][l]))]
                a, h = (cs.path_run(p.with_lam1(lm), r, A, b, 1e-6)
                        for r, lm in zip(run, (lam, ph["lambdas"][l])))
                fails = cs.path_check(a, h, kw["tol"], kw["gap_every"])
                assert not fails, (method, kind, l, fails)


def test_gloo_collectives_on_card_are_exact_or_raise(cuda, tmp_path):
    """Two gloo ranks on CUDA tensors: every collective the psum path
    needs is exact; the ring and the reduce-scatter raise on both ranks
    alike, up front (gloo would close the connections or abort), and the
    group still works after them."""
    from convex_optimization_tpu_torch.parallel.launch import run_ranks
    from test_torch_sharded_ranks import card_collectives_job

    out = run_ranks(card_collectives_job, 2, tmp_path, device="cuda:0",
                    backend="gloo", timeout_s=120, collective_timeout_s=30)
    for r in out:
        for name in ("psum", "pmax", "broadcast0", "all_gather",
                     "psum_after"):
            assert r[name] == 0.0, (name, r)
        for name in ("ring", "reduce_scatter"):
            assert r[name].startswith("RuntimeError: gloo takes no CUDA"), r


def test_group_batched_path_and_cv_on_card_match_cpu(cuda):
    """A weighted group_l2 path and 3-fold CV through K5's group prox, K6
    and K7 on the card against the same on the CPU (plain versions)."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    w = np.random.default_rng(5).uniform(0.5, 1.5, 32).astype(np.float32)
    probs = []
    for dev in (cuda, "cpu"):
        inst, _, _ = make_lasso_instance_host(
            5, 128, 512, penalty_kind="group_l2", ngroups=32, device=dev)
        probs.append(inst.problem.with_penalty(dataclasses.replace(
            inst.problem.penalty,
            weights=torch.as_tensor(w, device=dev))))
    _build.reset_launches()
    res_c = cot.lambda_path(probs[0], cfg, path_len=6, method="bcd_batch")
    assert _build.launches["batch_sweep_t"] == res_c.sweeps > 0
    res_h = cot.lambda_path(probs[1], cfg, path_len=6, method="bcd_batch")
    assert res_c.method_used == res_h.method_used == "bcd_batch"
    assert bool((res_c.converged.cpu() == res_h.converged).all())
    for l, lam in enumerate(res_c.lambdas.tolist()):
        if bool(res_c.converged[l]):
            gap = cot.duality_gap(probs[0].with_lam1(lam), res_c.xs[l],
                                  precise=True)
            assert float(gap.rel_gap) <= 2e-6
    torch.testing.assert_close(res_c.xs.cpu(), res_h.xs, rtol=0, atol=5e-3)
    cv_c = cot.cv_lambda_path(probs[0], cfg, k=3, path_len=5)
    cv_h = cot.cv_lambda_path(probs[1], cfg, k=3, path_len=5)
    assert cv_c.method_used == cv_h.method_used == "bcd_batch"
    assert cv_c.best_index == cv_h.best_index
    torch.testing.assert_close(cv_c.val_mse.cpu(), cv_h.val_mse, rtol=1e-3,
                               atol=0.0)


def test_fista_path_on_card_matches_cpu(cuda):
    """The FISTA path (the default method): K2 and K3 on the card against
    their plain versions on the CPU, point by point."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(tol=1e-5, max_iters=4000, gap_every=10,
                       stall_checks=20)
    inst_c, _, _ = make_lasso_instance_host(7, 200, 800, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(7, 200, 800, device="cpu")
    _build.reset_launches()
    res_c = cot.lambda_path(inst_c.problem, cfg, path_len=6,
                            lam_min_frac=0.05)
    assert _build.launches["ax_minus_b_t"] > res_c.sweeps > 0
    assert _build.launches["neg_at_r_t"] > res_c.sweeps
    res_h = cot.lambda_path(inst_h.problem, cfg, path_len=6,
                            lam_min_frac=0.05)
    assert res_c.method_used == res_h.method_used == "fista"
    assert bool((res_c.converged.cpu() == res_h.converged).all())
    assert (res_c.iters.cpu() - res_h.iters).abs().max() <= 10
    for l, lam in enumerate(res_c.lambdas.tolist()):
        if bool(res_c.converged[l]):
            gap = cot.duality_gap(inst_c.problem.with_lam1(lam),
                                  res_c.xs[l], precise=True)
            assert float(gap.rel_gap) <= 2e-5
    torch.testing.assert_close(res_c.xs.cpu(), res_h.xs, rtol=0, atol=5e-3)


def test_screened_nonneg_solve_on_card_matches_cpu(cuda):
    """Config 3's solve at a small shape (nonneg_l1, lam2 1e-3,
    screen_every=1, bcd_pallas) on the card against the CPU: step counts
    within one check, both certify after the polish, with the same
    support."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    kw = dict(tol=1e-6, max_iters=20_000, gap_every=10, stall_checks=15,
              block_size=128, screen_every=1)
    shape = dict(penalty_kind="nonneg_l1", lam2=1e-3)
    inst_c, A, b = make_lasso_instance_host(0, 500, 2000, device=cuda,
                                            **shape)
    inst_h, _, _ = make_lasso_instance_host(0, 500, 2000, device="cpu",
                                            **shape)
    res_c = cot.solve(inst_c.problem, "bcd_pallas", **kw)
    res_h = cot.solve(inst_h.problem, "bcd_pallas", **kw)
    assert abs(res_c.iterations - res_h.iterations) <= 10
    prs = [cot.polish_support(p, r.x, tol=1e-6, A_host=A, b_host=b)
           for p, r in ((inst_c.problem, res_c), (inst_h.problem, res_h))]
    assert max(pr.rel_gap for pr in prs) <= 1e-6
    np.testing.assert_array_equal(np.abs(prs[0].x) > 1e-4,
                                  np.abs(prs[1].x) > 1e-4)


@pytest.mark.parametrize("method,kind,ngroups", [
    ("fista_ws", "l1", 0), ("bcd_ws", "l1", 0), ("bcd_ws", "group_l2", 50)])
def test_working_set_on_card_matches_cpu(cuda, method, kind, ngroups):
    """fista_ws / bcd_ws on the card (K1-K4 on the full A_t and the
    slabs) against the CPU (plain versions), at tol 1e-6, where the f32
    rel_gap can end a run on the stall rule (g > 0.9 of the previous
    round's), which rounding decides: rounds within one, ws_size within
    one bucket, both polished to 1e-6 with the same support."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    shape = dict(penalty_kind=kind, ngroups=ngroups, lam1_frac=0.02)
    inst_c, A, b = make_lasso_instance_host(3, 500, 2000, device=cuda,
                                            **shape)
    inst_h, _, _ = make_lasso_instance_host(3, 500, 2000, device="cpu",
                                            **shape)
    kw = dict(tol=1e-6, max_iters=5000, gap_every=10, stall_checks=15)
    _build.reset_launches()
    res_c = cot.solve(inst_c.problem, method, **kw)
    launches = dict(_build.launches)
    res_h = cot.solve(inst_h.problem, method, **kw)
    assert launches["ax_minus_b_t"] > 0 and launches["neg_at_r_t"] > 0
    if method == "bcd_ws":
        assert launches["sweep_t"] > 0 and launches["block_power_t"] >= 1
        # one K4 for the burn-in, one per compact round
        assert launches["block_power_t"] == res_c.history["rounds"]
    assert abs(res_c.history["rounds"] - res_h.history["rounds"]) <= 1
    assert abs(res_c.history["ws_size"] - res_h.history["ws_size"]) <= 128
    assert res_c.history["ws_size"] < 2000
    prs = [cot.polish_support(p, r.x, tol=1e-6, A_host=A, b_host=b)
           for p, r in ((inst_c.problem, res_c), (inst_h.problem, res_h))]
    assert max(pr.rel_gap for pr in prs) <= 1e-6
    np.testing.assert_array_equal(np.abs(prs[0].x) > 0,
                                  np.abs(prs[1].x) > 0)


@pytest.mark.parametrize("setup", ["device", "host"])
def test_admm_on_card_matches_cpu(cuda, setup):
    """ADMM (Woodbury, m = 500) on the card: the Gram by torch.matmul with
    TF32 off, the loop's A q and A^T w by K2 and K3; both runs certified
    after the polish with the same support; a TF32 Gram is refused."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    inst_c, A, b = make_lasso_instance_host(3, 500, 2000, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(3, 500, 2000, device="cpu")
    kw = dict(tol=1e-5, max_iters=3000, gap_every=10, stall_checks=15,
              admm_setup=setup)
    _build.reset_launches()
    res_c = cot.solve(inst_c.problem, "admm", **kw)
    assert _build.launches["ax_minus_b_t"] > res_c.iterations > 0
    assert _build.launches["neg_at_r_t"] > res_c.iterations
    res_h = cot.solve(inst_h.problem, "admm", **kw)
    assert res_c.method == res_h.method == "admm"
    prs = [cot.polish_support(p, r.x, tol=1e-6, A_host=A, b_host=b)
           for p, r in ((inst_c.problem, res_c), (inst_h.problem, res_h))]
    assert max(pr.rel_gap for pr in prs) <= 1e-6
    np.testing.assert_array_equal(np.abs(prs[0].x) > 0,
                                  np.abs(prs[1].x) > 0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            cot.solve(inst_c.problem, "admm", **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("kw", [dict(compact=True), dict(method="admm")])
def test_compact_and_admm_paths_on_card_match_cpu(cuda, kw):
    """The compacting FISTA path (screens by K2/K3 on the full A_t) and
    the ADMM path on the card against the CPU: the same kept counts
    (compact), every converged point certified in f64, x within 5e-3."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(tol=1e-5, max_iters=4000, gap_every=10,
                       stall_checks=20)
    inst_c, _, _ = make_lasso_instance_host(7, 200, 800, device=cuda)
    inst_h, _, _ = make_lasso_instance_host(7, 200, 800, device="cpu")
    res_c = cot.lambda_path(inst_c.problem, cfg, path_len=6,
                            lam_min_frac=0.05, **kw)
    res_h = cot.lambda_path(inst_h.problem, cfg, path_len=6,
                            lam_min_frac=0.05, **kw)
    assert res_c.method_used == res_h.method_used
    if kw.get("compact"):
        assert res_c.method_used == "fista_compact"
        assert res_c.kept.cpu().tolist() == res_h.kept.tolist()
    for l, lam in enumerate(res_c.lambdas.tolist()):
        if bool(res_c.converged[l]):
            gap = cot.duality_gap(inst_c.problem.with_lam1(lam),
                                  res_c.xs[l], precise=True)
            assert float(gap.rel_gap) <= 2e-5
    torch.testing.assert_close(res_c.xs.cpu(), res_h.xs, rtol=0, atol=5e-3)


def test_cli_on_card_polishes_and_certifies(cuda, tmp_path, capsys):
    """The port CLI on the card: config 1 by bcd_pallas with the polish,
    the kernels of the solve launched, the snapshot certified in f64."""
    import json

    from convex_optimization_tpu_torch.cli import main
    from convex_optimization_tpu_torch.core.datagen import BENCH_CONFIGS
    from convex_optimization_tpu_torch.core.objective import duality_gap
    from convex_optimization_tpu_torch.utils.checkpoint import load_snapshot

    snap = str(tmp_path / "c1.npz")
    _build.reset_launches()
    assert main(["--config", "config1", "--method", "bcd_pallas",
                 "--polish", "--stall-checks", "15", "--checkpoint",
                 snap]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("sweep_t", "ax_minus_b_t", "neg_at_r_t", "block_power_t"):
        assert _build.launches[name] > 0, name
    assert out["m"] == 500 and out["n"] == 2000
    problem = BENCH_CONFIGS["config1"].instance(0, device="cpu").problem
    x = torch.from_numpy(load_snapshot(snap).x)
    assert float(duality_gap(problem, x, precise=True).rel_gap) <= 1e-6
    assert out.get("certified", out["converged"])


def test_polish_fast_device_variant_matches_host_variant(cuda):
    """polish_fast with the witness by K3 on the card (launched once) and
    with the chunked f64 host pass: both certified <= tol with the same
    support and x within 1e-7; the device screen keeps at least the host
    screen's columns (its margin is K3's rounding bound)."""
    from convex_optimization_tpu_torch.api import solve
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.polish import polish_fast

    inst, A, b = make_lasso_instance_host(3, 1000, 4000, device=cuda)
    res = solve(inst.problem, "bcd_pallas", tol=1e-6, max_iters=2000,
                stall_checks=15)
    host = polish_fast(inst.problem, res.x, tol=1e-9, A_host=A, b_host=b)
    _build.reset_launches()
    dev = polish_fast(inst.problem, res.x, tol=1e-9)
    assert _build.launches["neg_at_r_t"] == 1
    assert host.rel_gap <= 1e-9 and dev.rel_gap <= 1e-9
    np.testing.assert_array_equal(host.x != 0, dev.x != 0)
    np.testing.assert_allclose(dev.x, host.x, rtol=0, atol=1e-7)
    assert dev.kept >= host.kept


# ------------------------------------------------- K10: the polish's CD ----

def _cd_case(m, n, kind, lam2, lam_frac=0.1, seed=0):
    """A unit-column f32 A (F-ordered), b (f64) and lam1 for the polish's
    CD on the support; nonneg_l1 plants a nonnegative x."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    A = np.asfortranarray(A / np.linalg.norm(A, axis=0))
    xt = np.where(rng.random(n) < 0.1, rng.standard_normal(n), 0.0)
    if kind == "nonneg_l1":
        xt = np.abs(xt)
    b = A.astype(np.float64) @ xt + 0.01 * rng.standard_normal(m)
    atb = A.T.astype(np.float64) @ b
    lam1 = lam_frac * (atb.max() if kind == "nonneg_l1"
                       else np.abs(atb).max())
    return A, b, float(lam1)


#: (m, n, kind, lam2, lam_frac, support): k = 200 (not a multiple of the
#: block), the nonneg prox with lam2, the scalar instance (m % 4 != 0), a
#: support of one column, every column (the rescreen drops many mid-run)
#: and the headline's m (132 CTAs, B = 128)
CD_CASES = {
    "l1": (256, 600, "l1", 0.0, 0.1, "third"),
    "nonneg_l1": (256, 600, "nonneg_l1", 1e-3, 0.1, "third"),
    "ragged_m": (201, 600, "l1", 0.0, 0.1, "third"),
    "one_column": (256, 600, "l1", 0.0, 0.1, "one"),
    "rescreen": (256, 600, "nonneg_l1", 1e-3, 0.3, "all"),
    "headline_m": (10_000, 1500, "l1", 0.0, 0.1, "all"),
}


def _cd_inputs(name, cuda):
    from convex_optimization_tpu_torch.ops.cd64 import cd64_plan, support_slab
    from convex_optimization_tpu_torch.solvers.polish import _NpPenalty

    m, n, kind, lam2, frac, support = CD_CASES[name]
    A, b, lam1 = _cd_case(m, n, kind, lam2, frac)
    S = {"third": np.arange(0, n, 3), "all": np.arange(n),
         "one": np.array([int(np.argmax(np.abs(A.T @ b)))])}[support]
    B = cd64_plan(cuda, m).B
    rows = torch.from_numpy(np.ascontiguousarray(A.T)).to(cuda)
    slab = support_slab(rows, torch.as_tensor(S, device=cuda), B)
    As = np.asfortranarray(A[:, S])
    return (As, slab, B, b, lam2, _NpPenalty(kind, lam1),
            np.zeros(len(S)))


def _cd_both(name, cuda, tol, max_sweeps):
    from convex_optimization_tpu_torch.solvers.polish import _cd64, _cd64_card

    As, slab, B, b, lam2, pen, x0 = _cd_inputs(name, cuda)
    host = _cd64(As, b, lam2, pen, x0, tol, max_sweeps)
    card = _cd64_card(slab, B, b, lam2, pen, x0, tol, max_sweeps)
    return host, card, len(x0)


def _close_x(a, b):
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= 1e-10 * scale


def _gap_x_bound(As, keep, lam2, gaps):
    """||x_a - x_b||_2 that two points of gaps ``gaps`` may be apart on the
    columns ``keep``: the objective there is mu-strongly convex, mu the
    least eigenvalue of A_K^T A_K + lam2, so each lies within
    sqrt(2 gap / mu) of the one minimizer."""
    A_K = As[:, keep].astype(np.float64)
    mu = float(np.linalg.eigvalsh(A_K.T @ A_K)[0]) + lam2
    assert mu > 0.0
    return sum(np.sqrt(2.0 * max(g, 0.0) / mu) for g in gaps)


@pytest.mark.parametrize("name", list(CD_CASES))
def test_cd64_kernel_matches_host_cd_to_tolerance(cuda, name):
    """K10's CD (``_cd64_card``) against the host ``_cd64`` on the same
    gathered columns, run to a 1e-10 gap: the same keep_idx, sweeps within
    one check, x within what the two gaps allow (``_gap_x_bound``), and at
    equal sweeps x to 1e-10 relative."""
    As, slab, B, b, lam2, pen, x0 = _cd_inputs(name, cuda)
    from convex_optimization_tpu_torch.solvers.polish import _cd64, _cd64_card

    host = _cd64(As, b, lam2, pen, x0, 1e-10, 4000)
    card = _cd64_card(slab, B, b, lam2, pen, x0, 1e-10, 4000)
    k = len(x0)
    assert card[7] == "card" and host[7] in ("native", "numpy")
    np.testing.assert_array_equal(card[1], host[1])
    assert abs(card[2] - host[2]) <= 2
    assert card[3] <= 1e-10 and host[3] <= 1e-10
    bound = _gap_x_bound(As, host[1], lam2, (card[4], host[4]))
    assert float(np.linalg.norm(card[0] - host[0])) <= bound
    if card[2] == host[2]:
        _close_x(card[0], host[0])
    if name == "rescreen":
        assert len(card[1]) < k        # columns dropped mid-run


@pytest.mark.parametrize("name", list(CD_CASES))
def test_cd64_kernel_matches_host_cd_sweep_for_sweep(cuda, name):
    """Eight sweeps each (tol 0: no early stop but at a zero gap, which one
    column reaches in its first check; the rescreen at every check): the
    same sweeps and keep_idx, x to 1e-10 relative, r to 1e-10 of its
    size."""
    host, card, _ = _cd_both(name, cuda, 0.0, 8)
    assert card[2] == host[2] == (2 if name == "one_column" else 8)
    np.testing.assert_array_equal(card[1], host[1])
    _close_x(card[0], host[0])
    _close_x(card[6], host[6])


@pytest.mark.parametrize("name", ["l1", "ragged_m", "headline_m"])
def test_cd64_kernels_are_deterministic(cuda, name):
    """Two launches of K10 from the same x and r, and the check's two
    products twice: the same bits."""
    from convex_optimization_tpu_torch.ops.cd64 import (
        block_gram64,
        cd64_atr_t,
        cd64_residual_t,
        cd64_sweeps_t,
    )

    As, slab, B, b, lam2, pen, x0 = _cd_inputs(name, cuda)
    gram = block_gram64(slab, B)
    col_sq = torch.diagonal(gram, dim1=1, dim2=2).reshape(-1) + lam2
    col_sq[len(x0):] = 1.0
    x_start = torch.zeros((slab.shape[0],), dtype=torch.float64, device=cuda)
    b_dev = torch.from_numpy(b).to(cuda)
    outs = []
    for _ in range(2):
        x = x_start.clone()
        r = cd64_residual_t(slab, x, b_dev)
        cd64_sweeps_t(slab, x, r, col_sq, gram, pen.lam1, lam2,
                      pen.kind == "nonneg_l1", 3)
        outs.append((x, r, cd64_residual_t(slab, x, b_dev),
                     cd64_atr_t(slab, r, x, lam2)))
    torch.cuda.synchronize()
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("m", [256, 201])
def test_cd64_check_kernels_match_plain(cuda, m):
    """The check's f64 products against their plain versions, from a slab
    and through an index into A's rows: to 1e-12 of the sums of |terms|."""
    from convex_optimization_tpu_torch.ops.cd64 import (
        cd64_atr_t,
        cd64_atr_t_plain,
        cd64_residual_t,
        cd64_residual_t_plain,
    )

    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.standard_normal((700, m)).astype(np.float32))
    x = torch.from_numpy(np.where(rng.random(700) < 0.3,
                                  rng.standard_normal(700), 0.0))
    b = torch.from_numpy(rng.standard_normal(m))
    idx = torch.from_numpy(rng.permutation(700)[:300])
    Ad, xd, bd, idd = (t.to(cuda) for t in (A, x, b, idx))
    r = cd64_residual_t(Ad, xd, bd)
    r_ref = cd64_residual_t_plain(A, x, b)
    scale = (A.double().abs().T @ x.abs()) + b.abs()
    assert bool(((r.cpu() - r_ref).abs() <= 1e-12 * scale).all())
    for ix in (None, idd):
        xs = None if ix is None else xd[ix]
        z = cd64_atr_t(Ad, r, xs, 1e-3, idx=ix).cpu()
        z_ref = cd64_atr_t_plain(A, r.cpu(), None if xs is None else
                                 xs.cpu(), 1e-3,
                                 idx=None if ix is None else idx)
        rows = A if ix is None else A[idx]
        zscale = rows.double().abs() @ r.cpu().abs() + 1e-3
        assert bool(((z - z_ref).abs() <= 1e-12 * zscale).all())


def test_cd64_wrappers_count_launches(cuda):
    from convex_optimization_tpu_torch.ops.cd64 import (
        block_gram64,
        cd64_atr_t,
        cd64_residual_t,
        cd64_sweeps_t,
    )

    As, slab, B, b, lam2, pen, x0 = _cd_inputs("l1", cuda)
    gram = block_gram64(slab, B)
    col_sq = torch.ones((slab.shape[0],), dtype=torch.float64, device=cuda)
    x = torch.zeros_like(col_sq)
    before = dict(_build.launches)
    r = cd64_residual_t(slab, x, torch.from_numpy(b).to(cuda))
    cd64_sweeps_t(slab, x, r, col_sq, gram, pen.lam1, 0.0, False, 2)
    cd64_atr_t(slab, r, x, 0.0)
    for name in ("cd64_residual_t", "cd64_sweeps_t", "cd64_atr_t"):
        assert _build.launches[name] == before.get(name, 0) + 1
    with pytest.raises(ValueError):
        cd64_sweeps_t(slab, x.float(), r, col_sq, gram, 1.0, 0.0, False, 2)
    with pytest.raises(ValueError):
        cd64_sweeps_t(slab[:-1], x[:-1], r, col_sq[:-1], gram, 1.0, 0.0,
                      False, 2)


def test_cd64_plan_refuses_an_m_no_layout_fits(cuda):
    """Past the m whose slice of r no layout holds, K10's plan raises, and
    so does the card route of the polish: it never falls back to the
    host for a problem on the card."""
    import types

    from convex_optimization_tpu_torch.ops.cd64 import cd64_plan
    from convex_optimization_tpu_torch.solvers.polish import _card_plan

    m = 700_000
    with pytest.raises(ValueError, match=f"m = {m}"):
        cd64_plan(cuda, m)
    with pytest.raises(ValueError, match=f"m = {m}"):
        _card_plan(types.SimpleNamespace(device=cuda, m=m))
    assert cd64_plan(cuda, 10_000).B == 128


def _polish_routes(problem, x, monkeypatch):
    """polish_support on the card route and on the host route (the plan
    forced to None), each with the route its cd64 span read."""
    from torch.profiler import ProfilerActivity, profile

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.solvers import polish
    from convex_optimization_tpu_torch.utils import trace

    out = []
    for force_host in (False, True):
        if force_host:
            monkeypatch.setattr(polish, "_card_plan", lambda p: None)
        with profile(activities=[ProfilerActivity.CPU]):
            pr = cot.polish_support(problem, x, tol=1e-6)
        spans = [s for s in trace.RECORDER.records(trace.RECORDER.session)
                 if s["name"] == "cot.polish.cd64"]
        out.append((pr, {s["attrs"]["route"] for s in spans}))
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-3)])
def test_polish_support_card_route_matches_host_route(cuda, monkeypatch,
                                                      kind, lam2):
    """Config 1's size (500 x 2000) solved on the card, then polished on
    the card route (K10, the slab gathered on the card) and on the host
    route: the same kept columns, both certified <= 1e-6, gaps within
    1e-9, and K10 launched only on the card route."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    inst, A, b = make_lasso_instance_host(0, 500, 2000, penalty_kind=kind,
                                          lam2=lam2, device=cuda)
    res = cot.solve(inst.problem, "bcd_pallas", tol=1e-6, max_iters=20_000,
                    stall_checks=15)
    _build.reset_launches()
    (card, card_route), (host, host_route) = _polish_routes(
        inst.problem, res.x, monkeypatch)
    assert card_route == {"card"} and host_route <= {"native", "numpy"}
    assert _build.launches["cd64_sweeps_t"] > 0
    assert card.kept == host.kept
    assert card.rel_gap <= 1e-6 and host.rel_gap <= 1e-6
    assert abs(card.gap - host.gap) <= 1e-9
    gap = cot.duality_gap(inst.problem, torch.from_numpy(card.x).to(cuda),
                          precise=True)
    assert float(gap.rel_gap) <= 1e-6
