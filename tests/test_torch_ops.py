"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode on the same arrays.

Inputs come from numpy generators with fixed seeds and go to both
packages as numpy arrays.  Tolerances and why:
  * K1 sweep: max|dx| <= 1e-5 max(1, ||x||_inf) and ||dr|| <= 1e-5 ||r||
    after one sweep, 1e-4 after ten: the f32 sums run in another order, and
    Gauss-Seidel carries each block's rounding into the next;
  * K2 / K3: 1e-5 relative to ||A||_F ||x|| (one f32 pass over A);
  * K4: rtol 1e-4 (48 power iterations from the same start vector);
  * K9 sweep: as K1 after one sweep (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.ops.bcd_sweep_pallas_tiled import (
    bcd_sweep_pallas_tiled,
)
from convex_optimization_tpu.ops.bcd_sweep_vpu import (
    bcd_sweep_vpu,
    to_tblock_major as j_to_tblock_major,
)
from convex_optimization_tpu.ops.matvec_pallas import (
    ax_minus_b_t as j_ax_minus_b_t,
    block_power_t as j_block_power_t,
    neg_at_r_t as j_neg_at_r_t,
    spectral_norm_sq_t as j_spectral_norm_sq_t,
)
from convex_optimization_tpu_torch.core.problem import problem_from_numpy
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    H100_SMS,
    K1_THREADS,
    MAX_SMEM_BYTES,
    block_steps,
    k1_smem_bytes,
    sweep_route,
    sweep_t,
    sweep_tiling,
    to_tblock_major,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_batch import (
    K5_MAX_SMEM_BYTES,
    K5_THREADS,
    batch_sweep_tiling,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu_torch.ops.bcd_sweep_tiled import (
    sweep_tiled_t,
    sweep_tiled_t_plain,
)
from convex_optimization_tpu_torch.solvers.bcd import pick_sweep
from convex_optimization_tpu_torch.utils import native
from convex_optimization_tpu_torch.ops.matvec import (
    K3_MAX_COLS,
    K4_MIN_SLICE,
    K4_SCRATCH_BYTES,
    ax_minus_b_t,
    block_power_t,
    k3_chunking,
    k3_depth,
    matvec_tiling,
    neg_at_r_t,
    power_tiling,
    spectral_norm_sq_t,
    witness_gamma,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs under several xdist workers: keep torch to 2 threads
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(m, n, seed, kind="l1", sparse=0.1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32).T   # column-major
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    x = np.where(rng.random(n) < sparse, rng.standard_normal(n), 0.0)
    x = x.astype(np.float32)
    if kind == "nonneg_l1":
        x = np.abs(x)
    b = rng.standard_normal(m).astype(np.float32)
    mask = rng.random(n) > 0.1
    return A, b, x, mask


def _pair(A, b, kind, lam1, lam2, B, ngroups=0, weights=None):
    pen = JPenalty(lam1=lam1, kind=kind, ngroups=ngroups,
                   weights=None if weights is None else jnp.asarray(weights))
    jp = JProblem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=pen, lam2=lam2)
    tp = problem_from_numpy(A, b, kind, lam1, lam2, ngroups, weights,
                            block=B, device="cpu")
    return jp, tp


# one compiled interpret-mode sweep per shape instead of one per call
_j_sweep = jax.jit(lambda p, x, r, L, keep: bcd_sweep_vpu(
    p, x, r, L, keep_mask=keep, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))


def _sweep_close(x_t, r_t, x_j, r_j, tol):
    x_j, r_j = np.asarray(x_j), np.asarray(r_j)
    dx = np.abs(x_t.numpy() - x_j).max()
    assert dx <= tol * max(1.0, np.abs(x_j).max()), dx
    dr = np.linalg.norm(r_t.numpy() - r_j)
    assert dr <= tol * np.linalg.norm(r_j), dr


@pytest.mark.parametrize("B", [32, 40, 80])
@pytest.mark.parametrize("kind,lam2,masked", [
    ("l1", 0.0, False),
    ("l1", 0.3, True),
    ("nonneg_l1", 0.0, True),
    ("nonneg_l1", 0.1, False),
])
def test_sweep_plain_matches_jax_kernel(B, kind, lam2, masked):
    m, n = 240, 960
    A, b, x, mask = _arrays(m, n, seed=B, kind=kind)
    lam1 = 0.1 * float(np.abs(A.T @ b).max())
    jp, tp = _pair(A, b, kind, lam1, lam2, B)
    L = block_power_t(tp.A_t)
    steps = block_steps(L, lam2)
    keep = mask if masked else None
    xj, rj = jnp.asarray(x), jnp.asarray(A @ x - b)
    xt, rt = _t(x), _t(A @ x - b)
    xr, rr = xt, rt
    for sweeps in range(1, 11):
        xj, rj = _j_sweep(jp, xj, rj, jnp.asarray(L.numpy()),
                          None if keep is None else jnp.asarray(keep))
        xt, rt = sweep_t(tp.A_t, xt, rt, steps,
                         None if keep is None else _t(keep), tp.penalty, lam2)
        xr, rr = bcd_sweep_ref(tp, xr, rr, L, range(n // B),
                               keep_mask=None if keep is None else _t(keep))
        if sweeps in (1, 10):
            tol = 1e-5 if sweeps == 1 else 1e-4
            _sweep_close(xt, rt, xj, rj, tol)
            _sweep_close(xt, rt, xr.numpy(), rr.numpy(), tol)
    if masked:
        assert bool((xt[~_t(mask)] == 0).all())


@pytest.mark.parametrize("lam2", [0.0, 0.1])
def test_sweep_plain_group_l2_matches_jax_kernel(lam2):
    m, n, B, ngroups = 128, 512, 32, 64
    A, b, x, _ = _arrays(m, n, seed=5)
    w = np.random.default_rng(6).uniform(0.5, 2.0, ngroups)
    jp, tp = _pair(A, b, "group_l2", 0.2, lam2, B, ngroups, w)
    L = block_power_t(tp.A_t)
    xj, rj = bcd_sweep_vpu(jp, jnp.asarray(x), jnp.asarray(A @ x - b),
                           jnp.asarray(L.numpy()), interpret=True)
    xt, rt = sweep_t(tp.A_t, _t(x), _t(A @ x - b), block_steps(L, lam2),
                     None, tp.penalty, lam2)
    _sweep_close(xt, rt, xj, rj, 1e-5)


@pytest.mark.parametrize("kind", ["l1", "nonneg_l1", "group_l2"])
@pytest.mark.parametrize("masked,step_scale,lam2", [(True, 1.0, 0.0),
                                                    (False, 0.5, 0.1)])
def test_tiled_sweep_plain_matches_jax_kernel(kind, masked, step_scale,
                                              lam2):
    """K9's wrapper (its plain version on the CPU) against the JAX
    package's m-tiled Pallas sweep in interpret mode, one sweep."""
    m, n, B = 64, 512, 128
    A, b, x, mask = _arrays(m, n, seed=11, kind=kind)
    ngroups, w = 0, None
    atb = np.abs(A.T @ b)
    if kind == "group_l2":
        ngroups = 16
        w = np.random.default_rng(12).uniform(0.5, 2.0, ngroups)
        atb = np.linalg.norm((A.T @ b).reshape(ngroups, -1), axis=1) / w
    jp, tp = _pair(A, b, kind, 0.1 * float(atb.max()), lam2, B, ngroups, w)
    L = block_power_t(tp.A_t)
    keep = mask if masked else None
    r = A @ x - b
    xj, rj = bcd_sweep_pallas_tiled(
        jp, jnp.asarray(x), jnp.asarray(r), jnp.asarray(L.numpy()),
        step_scale=step_scale,
        keep_mask=None if keep is None else jnp.asarray(keep),
        interpret=True)
    args = (tp.A_t, _t(x), _t(r), block_steps(L, lam2, step_scale),
            None if keep is None else _t(keep), tp.penalty, lam2)
    xt, rt = sweep_tiled_t(*args)
    _sweep_close(xt, rt, xj, rj, 1e-5)
    xp, rp = sweep_tiled_t_plain(*args)
    assert torch.equal(xt, xp) and torch.equal(rt, rp)
    assert float((xt - _t(x)).abs().max()) > 0      # the sweep moved x
    if masked:
        assert bool((xt[~_t(mask)] == 0).all())


@pytest.mark.parametrize("B,m,route", [(80, 10_000, "k1"),
                                       (80, 100_000, "k9"),
                                       (200, 20_000, "k1"),
                                       (2000, 20_000, "k9")])
def test_sweep_route_fit_rule(B, m, route):
    """K1 where its (B x ceil(m / 132)) tile fits the 227 KB of shared
    memory, K9 otherwise; a CPU problem routes the same way."""
    assert sweep_route(B, m, H100_SMS, MAX_SMEM_BYTES) == route
    fits = k1_smem_bytes(B, m, H100_SMS) <= MAX_SMEM_BYTES
    assert fits == (route == "k1")
    want = sweep_t if route == "k1" else sweep_tiled_t
    assert pick_sweep(torch.device("cpu"), B, m) is want


@pytest.mark.parametrize("B", [32, 40, 80])
def test_matvec_plain_match_jax_kernels(B):
    m, n = 200, 960
    A, b, x, _ = _arrays(m, n, seed=B + 1)
    A_t_np = np.ascontiguousarray(A.T).reshape(n // B, B, m)
    jA_t = j_to_tblock_major(jnp.asarray(A), n // B)
    np.testing.assert_array_equal(np.asarray(jA_t), A_t_np)
    A_t = _t(A_t_np)
    scale = np.linalg.norm(A) * np.linalg.norm(x)
    r = ax_minus_b_t(A_t, _t(x), _t(b)).numpy()
    r_j = np.asarray(j_ax_minus_b_t(jA_t, jnp.asarray(x), jnp.asarray(b),
                                    interpret=True))
    assert np.abs(r - r_j).max() <= 1e-5 * scale
    z = neg_at_r_t(A_t, _t(r_j), _t(x), 0.3).numpy()
    z_j = np.asarray(j_neg_at_r_t(jA_t, jnp.asarray(r_j), jnp.asarray(x),
                                  0.3, interpret=True))
    assert np.abs(z - z_j).max() <= 1e-5 * np.linalg.norm(A) * \
        np.linalg.norm(r_j)


@pytest.mark.parametrize("m,n,B", [(96, 512, 32), (200, 800, 40),
                                   (256, 640, 80)])
def test_block_power_plain_matches_jax_kernel(m, n, B):
    A, _, _, _ = _arrays(m, n, seed=m)
    A_t_np = np.ascontiguousarray(A.T).reshape(n // B, B, m)
    est = block_power_t(_t(A_t_np)).numpy()
    ref = np.asarray(j_block_power_t(jnp.asarray(A_t_np), interpret=True))
    np.testing.assert_allclose(est, ref, rtol=1e-4)


def _gram_power(A_t, iters=48, safety=1.02):
    """K4's formulation on the card, in plain torch: G_j = A_t[j] A_t[j]^T,
    the TPU kernel's iterates on G_j (w = G_j v, v = w / max(||w||,
    1e-30)), then v^T G_j v / max(v^T v, 1e-30) times ``safety``."""
    nb, B, m = A_t.shape
    G = torch.bmm(A_t, A_t.transpose(1, 2))
    b = torch.arange(B, dtype=torch.float32)
    v = (1.0 + (0.01 * b) / B).expand(nb, B).unsqueeze(2)
    for _ in range(iters):
        w = torch.bmm(G, v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            min=1e-30)
    num = torch.sum(v * torch.bmm(G, v), dim=(1, 2))
    den = torch.clamp(torch.sum(v * v, dim=(1, 2)), min=1e-30)
    return safety * num / den


@pytest.mark.parametrize("B", [32, 40, 80, 200])
def test_gram_power_matches_jax_kernel(B):
    """The reassociation K4 runs on the card (iterate on the Gram matrix,
    not on A_j twice per step) computes the JAX kernel's function: rtol
    1e-4 against ``block_power_t`` in interpret mode, with one all-zero
    block, which both give as 0."""
    m, nb = 120, 3
    A, _, _, _ = _arrays(m, nb * B, seed=B + 7)
    A_t_np = np.ascontiguousarray(A.T).reshape(nb, B, m)
    A_t_np[1] = 0.0
    est = _gram_power(_t(A_t_np)).numpy()
    ref = np.asarray(j_block_power_t(jnp.asarray(A_t_np), interpret=True))
    assert est[1] == 0.0 and ref[1] == 0.0
    np.testing.assert_allclose(est, ref, rtol=1e-4)


@pytest.mark.parametrize("nb,B,m,tile,S,route", [
    (1250, 80, 10_000, 80, 1, "smem"),       # the headline
    (625, 80, 5000, 80, 1, "smem"),          # config 2, a rank's slab
    (1000, 200, 20_000, 200, 1, "smem"),     # config 4, K1's route
    (100, 2000, 20_000, 128, 1, "global"),   # config 4, K9's route
    (1, 80, 100_000, 80, 48, "smem"),        # one block: the m split
    (1, 200, 40_001, 200, 19, "smem"),
    (20, 40, 200, 80, 1, "smem"),            # too narrow to split
    (3, 240, 1000, 128, 1, "smem"),          # the widest G_j on chip
    (3, 241, 1000, 128, 1, "global"),
])
def test_power_tiling(nb, B, m, tile, S, route):
    """K4's plan: the tile by B, the m columns split only where the tiles
    leave the card idle (slices of >= 2048 columns, a multiple of 32,
    none empty), G_j on chip where it fits 227 KB with v and w, and the
    scratch of a call within K4_SCRATCH_BYTES."""
    plan = power_tiling(nb, B, m, H100_SMS)
    assert (plan.tile, plan.slices, plan.route) == (tile, S, route)
    assert plan.per_slice % 32 == 0
    assert (plan.slices - 1) * plan.per_slice < m <= \
        plan.slices * plan.per_slice
    if plan.slices > 1:
        assert plan.per_slice >= K4_MIN_SLICE
    assert plan.chunk == nb
    scratch = 4 * plan.chunk * B * B * (1 + (S if S > 1 else 0))
    assert scratch <= K4_SCRATCH_BYTES


def test_power_tiling_chunks_what_does_not_fit():
    """Blocks whose Grams would pass K4_SCRATCH_BYTES go in chunks."""
    plan = power_tiling(400, 4000, 20_000, H100_SMS)
    assert plan.route == "global" and plan.slices == 1
    assert plan.chunk == K4_SCRATCH_BYTES // (4 * 4000 * 4000 + 8 * 4000)
    assert 4 * plan.chunk * 4000 * (4000 + 2) <= K4_SCRATCH_BYTES < 400 * \
        4 * 4000 * 4000


def test_spectral_norm_sq_t_matches_jax():
    A, _, _, _ = _arrays(64, 256, seed=3)
    A_t_np = np.ascontiguousarray(A.T).reshape(8, 32, 64)
    est = float(spectral_norm_sq_t(_t(A_t_np), iters=24))
    ref = float(j_spectral_norm_sq_t(jnp.asarray(A_t_np), iters=24,
                                     interpret=True))
    assert abs(est - ref) <= 1e-4 * ref
    assert est >= 0.999 * np.linalg.norm(A, 2) ** 2


def test_to_tblock_major_matches_jax():
    A, _, _, _ = _arrays(24, 96, seed=2)
    got = to_tblock_major(_t(np.ascontiguousarray(A)), 4).numpy()
    want = np.asarray(j_to_tblock_major(jnp.asarray(A), 4))
    np.testing.assert_array_equal(got, want)


def test_launch_counters_stay_zero_on_cpu():
    _build.reset_launches()
    m, n, B = 64, 256, 32
    A, b, x, mask = _arrays(m, n, seed=9)
    _, tp = _pair(A, b, "l1", 0.1, 0.0, B)
    L = block_power_t(tp.A_t)
    r = ax_minus_b_t(tp.A_t, _t(x), tp.b)
    neg_at_r_t(tp.A_t, r, _t(x), 0.0)
    sweep_t(tp.A_t, _t(x), r, block_steps(L, 0.0), _t(mask), tp.penalty, 0.0)
    sweep_tiled_t(tp.A_t, _t(x), r, block_steps(L, 0.0), _t(mask),
                  tp.penalty, 0.0)
    assert sum(_build.launches.values()) == 0


def test_wrappers_refuse_other_devices():
    A_t = torch.empty((2, 8, 16), device="meta")
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError):
        ax_minus_b_t(A_t, x, torch.empty(16, device="meta"))
    with pytest.raises(ValueError):
        neg_at_r_t(A_t, x, x, 0.0)
    with pytest.raises(ValueError):
        block_power_t(A_t)


def _first_k3_depth(m):
    """K3's depth before its redesign: ceil(m / 2048) + 11."""
    return -(-m // 2048) + 11


@pytest.mark.parametrize("m", [8, 200, 2049, 5000, 10_000, 20_000, 50_000,
                               10**6])
def test_k3_depth_and_witness_gamma(m):
    eps = float(np.finfo(np.float32).eps)
    log2m = int(np.ceil(np.log2(m)))
    jax_gamma = (log2m + 4) * eps
    first = max(log2m + 4, -(-_first_k3_depth(m) // 2) + 4) * eps
    g = witness_gamma(m)
    # never below the JAX package's margin, never above the first design's
    assert jax_gamma <= g <= first
    assert g >= k3_depth(m) * eps / 2          # covers K3's depth (D u)
    if 2048 <= m <= 50_000:
        assert k3_depth(m) <= 2 * log2m
        assert g == jax_gamma                  # the JAX margin holds


def test_k3_depth_bounds_at_every_m():
    """The K3 note's promise over every m: D(m) never above the first
    design's, and within 2 ceil(log2 m) from 2048 to 50 000."""
    for m in range(1, 60_001):
        assert k3_depth(m) <= _first_k3_depth(m), m
        if 2048 <= m <= 50_000:
            assert k3_depth(m) <= 2 * int(np.ceil(np.log2(m))), m
    assert [k3_depth(m) for m in (5000, 10_000, 20_000, 50_000)] == \
        [14, 16, 18, 20]


@pytest.mark.parametrize("n,m", [(100_000, 10_000), (50_000, 5_000),
                                 (200_000, 20_000), (250_000, 50_000),
                                 (800, 201), (1024, 256), (96, 8),
                                 (320, 30_001)])
@pytest.mark.parametrize("k2_per_sm,k3_per_sm", [(2, 2), (4, 3), (1, 1)])
def test_matvec_tiling(n, m, k2_per_sm, k3_per_sm):
    """K2's grid fills at most one wave of co-resident CTAs, K3's grid
    too, no K2 slice, K3 chunk or K3 CTA is empty, and ragged m takes
    the scalar instances."""
    sms = 132
    p = matvec_tiling(n, m, sms, k2_per_sm, k3_per_sm)
    assert p.vec == (m % 4 == 0)
    assert p.k2_tiles * 1024 >= m > (p.k2_tiles - 1) * 1024
    assert p.k2_tiles * p.k2_slices <= max(k2_per_sm * sms, p.k2_tiles)
    per_slice = -(-n // p.k2_slices)
    assert (p.k2_slices - 1) * per_slice < n <= p.k2_slices * per_slice
    W, C = p.k3_width, p.k3_chunks
    assert W % 1024 == 0 and W <= K3_MAX_COLS
    assert W * C >= m > W * (C - 1)
    assert (W, C, p.k3_chain) == k3_chunking(m)
    assert p.k3_ctas * C <= max(k3_per_sm * sms, C)
    assert (p.k3_ctas - 1) * 16 < n
    if m % 4 == 0 and n >= 50_000:     # the main paths fill the card
        assert p.k2_tiles * p.k2_slices > (k2_per_sm * sms) // 2
        assert p.k3_ctas * C > (k3_per_sm * sms) // 2


def _first_k5_smem(B, m, L, gsize, sms=132):
    """The first K5 design's shared memory (the old rule): one CTA per SM,
    an odd tile stride rows | 1, L + 1 residual and mask rows, dx (L, B),
    and for group_l2 X's slice and the group scales."""
    rows = -(-m // min(sms, m))
    group = L * B + L * (B // gsize) if gsize else 0
    return 4 * (B * (rows | 1) + L * rows + rows + L * B + group)


def _k5_plan_invariants(p, B, m, L, sms=132):
    """What csrc/sweep_batch.cu's plan_ok demands of every plan."""
    LP = -(-L // 4) * 4
    assert p.grid <= min(sms, m)
    assert p.grid * p.rows >= m > (p.grid - 1) * p.rows
    assert p.smem_bytes <= K5_MAX_SMEM_BYTES
    assert 0 <= p.prefetch <= B and p.ld >= p.rows
    if p.vec:
        assert m % 4 == 0 and p.rows % 4 == 0 and p.ld % 8 == 4
    else:
        assert p.ld % 2 == 1
    assert p.s1 == 1 or p.s1 * -(-B // 2) <= K5_THREADS
    units2 = LP // 4 * (p.rows // 4 if p.vec else p.rows)
    assert p.s2 == 1 or (p.s2 <= B and p.s2 * units2 <= K5_THREADS)
    assert p.rw in (1, K5_THREADS // 32)


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("L", [1, 3, 10, 16])
@pytest.mark.parametrize("m", [201, 5000, 10_000, 20_000])
@pytest.mark.parametrize("B", [8, 80, 200])
def test_k5_tiling_takes_every_shape_the_first_design_took(B, m, L, group):
    gsize = B if group else 0
    p = batch_sweep_tiling(B, m, L, gsize, 132)
    if _first_k5_smem(B, m, L, gsize) <= K5_MAX_SMEM_BYTES:
        assert p is not None
    if p is not None:
        _k5_plan_invariants(p, B, m, L)


@pytest.mark.parametrize("B,L,ragged", [(400, 1, False), (400, 16, True),
                                        (1000, 4, False), (1000, 10, True),
                                        (2000, 4, False)])
def test_k5_tiling_takes_the_first_designs_largest_tiles(B, L, ragged):
    """At the edge of the old rule (the largest m it took at B and L) the
    plan still fits, through the scalar unsplit layout if need be."""
    gsize = 0 if ragged else 8
    m = 4 * 132
    while _first_k5_smem(B, m + 4 * 132, L, gsize) <= K5_MAX_SMEM_BYTES:
        m += 4 * 132
    while _first_k5_smem(B, m + 1, L, gsize) <= K5_MAX_SMEM_BYTES:
        m += 1
    m -= int(m % 4 == 0) if ragged else m % 4
    assert _first_k5_smem(B, m, L, gsize) <= K5_MAX_SMEM_BYTES
    p = batch_sweep_tiling(B, m, L, gsize, 132)
    assert p is not None
    _k5_plan_invariants(p, B, m, L)


@pytest.mark.parametrize("B,m,L,gsize", [(80, 5000, L, 0)
                                         for L in (1, 4, 10, 16)]
                         + [(80, 10_000, 10, 0), (80, 5000, 10, 8)])
def test_k5_tiling_double_buffers_config2_and_cv(B, m, L, gsize):
    p = batch_sweep_tiling(B, m, L, gsize, 132)
    assert p.vec and p.prefetch == B
    assert p.s1 > 1 and p.s2 > 1
    _k5_plan_invariants(p, B, m, L)


def test_k5_tiling_prefetches_part_of_config4s_group_tile():
    p = batch_sweep_tiling(200, 20_000, 10, 200, 132)
    assert p.vec and p.rows == 152 and p.grid == 132
    assert 0 < p.prefetch < 200
    _k5_plan_invariants(p, 200, 20_000, 10)


@pytest.mark.parametrize("m", [201, 5001, 10_003])
def test_k5_tiling_takes_the_scalar_instance_at_ragged_m(m):
    p = batch_sweep_tiling(80, m, 10, 0, 132)
    assert not p.vec and p.ld % 2 == 1
    _k5_plan_invariants(p, 80, m, 10)


def _k1_plan_invariants(p, B, m, sms=132):
    """What csrc/sweep.cu's plan_ok demands of every K1 / K8 plan."""
    assert p.grid <= min(sms, m)
    assert p.grid * p.rows >= m > (p.grid - 1) * p.rows
    assert p.smem_bytes <= MAX_SMEM_BYTES
    assert 0 <= p.prefetch <= B and p.ld >= p.rows
    if p.vec:
        assert m % 4 == 0 and p.rows % 4 == 0 and p.ld % 8 == 4
    assert p.s1 == 1 or p.s1 * -(-B // 2) <= K1_THREADS
    q = p.rows // 4 if p.vec else p.rows
    assert p.s2 == 1 or (p.s2 <= B and p.s2 * q <= K1_THREADS)
    assert p.rw in (1, K1_THREADS // 32)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("m", [201, 5000, 10_000, 20_000, 100_000])
@pytest.mark.parametrize("B", [8, 32, 80, 200, 400, 2000])
def test_k1_tiling_takes_every_shape_the_first_design_took(B, m, sms):
    """Every (B, m) that sweep_route sends to K1 (the first design's fit
    rule, unchanged) gets a plan that fits, on the H100 SXM's 132 SMs and
    the PCIe card's 114: no block moves between K1 and K9."""
    p = sweep_tiling(B, m, sms)
    if sweep_route(B, m, sms) == "k1":
        assert p is not None
    if p is not None:
        _k1_plan_invariants(p, B, m, sms)


@pytest.mark.parametrize("B,ragged", [(80, False), (200, True),
                                      (400, False), (1000, True)])
def test_k1_tiling_takes_the_first_designs_largest_tiles(B, ragged):
    """At the edge of the fit rule (the largest m it sends to K1 at B) the
    plan still fits, through the first design's layout if need be; one row
    more goes to K9."""
    m = 132
    while k1_smem_bytes(B, m + 132, H100_SMS) <= MAX_SMEM_BYTES:
        m += 132
    while k1_smem_bytes(B, m + 1, H100_SMS) <= MAX_SMEM_BYTES:
        m += 1
    assert sweep_route(B, m + 1, H100_SMS) == "k9"
    m -= int(m % 4 == 0) if ragged else m % 4
    assert sweep_route(B, m, H100_SMS) == "k1"
    p = sweep_tiling(B, m, H100_SMS)
    assert p is not None
    _k1_plan_invariants(p, B, m)


@pytest.mark.parametrize("name,B,m", [("headline", 80, 10_000),
                                      ("config3", 80, 10_000),
                                      ("rank_slab", 80, 10_000),
                                      ("config2", 80, 5000)])
def test_k1_tiling_double_buffers_the_headline_and_the_rank_slab(name, B, m):
    """The headline's and config 3's A_t (1250 x 80 x 10 000) and a rank's
    slab of it (625 x 80 x 10 000) share K1's tile: two of them fit, so the
    plan is a whole double buffer, the float4 instance, both phases
    split."""
    p = sweep_tiling(B, m, H100_SMS)
    assert p.vec and p.prefetch == B
    assert p.s1 > 1 and p.s2 > 1
    if m == 10_000:
        assert p.rows == 76 and p.grid == 132
    _k1_plan_invariants(p, B, m)


def test_k1_tiling_prefetches_part_of_config4s_group_tile():
    """Config 4's K1 route (B = 200, m = 20 000, groups of 200): one tile
    is 122 KB, so only part of the next fits beside it."""
    p = sweep_tiling(200, 20_000, H100_SMS)
    assert p.vec and p.rows == 152 and p.grid == 132
    assert 0 < p.prefetch < 200
    _k1_plan_invariants(p, 200, 20_000)


@pytest.mark.parametrize("m", [201, 5001, 10_003])
def test_k1_tiling_takes_the_scalar_instance_at_ragged_m(m):
    p = sweep_tiling(80, m, H100_SMS)
    assert not p.vec and p.ld % 2 == 1
    _k1_plan_invariants(p, 80, m)


def test_jax_runs_on_cpu_here():
    # the JAX references above ran on the CPU backend (interpret mode)
    assert jax.default_backend() == "cpu"


class _FakeLib:
    """Records what a ``_declare`` sets on each entry point."""

    def __getattr__(self, name):
        import types

        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


def _c_params(paths, sig):
    """{entry point: number of parameters} of the C functions in ``paths``
    whose signature matches ``sig``."""
    found = {}
    for path in paths:
        with open(path) as f:
            for name, params in sig.findall(f.read()):
                found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_ctypes_declarations_match_the_c_entry_points():
    """Every extern "C" entry point in csrc/ is declared to ctypes with as
    many argument types as its C signature has parameters (ctypes passes
    surplus arguments through unchecked, so a missing one is a crash on the
    card, not an error)."""
    import re

    lib = _FakeLib()
    _build._declare(lib)
    found = _c_params(_build.sources(), re.compile(
        r"^(?:int|const char\*) (cot_\w+)\(([^)]*)\)\s*\{", re.M))
    assert len(found) >= 14
    assert {"cot_sweep_t", "cot_sweep_check", "cot_sweep_tiled_check",
            "cot_sweep_tiled_t", "cot_sweep_slab_t"} <= set(found)
    for name, n_params in found.items():
        assert len(getattr(lib, name).argtypes) == n_params, name


def test_native_declarations_match_the_c_entry_points():
    """The same count for every native host entry point the port binds
    (``utils/native._declare``) against ``native/co_native.cpp``."""
    import os
    import re

    lib = _FakeLib()
    native._declare(lib)
    declared = {name for name, fn in vars(lib).items()
                if hasattr(fn, "argtypes")}
    assert {"co_cd64_group_sweeps", "co_group_power_l"} <= declared
    found = _c_params([native._SRC], re.compile(
        r"^(?:void|int) (co_\w+)\(([^)]*)\)\s*\{", re.M))
    assert os.path.basename(native._SRC) == "co_native.cpp"
    for name in declared:
        assert len(getattr(lib, name).argtypes) == found[name], name
