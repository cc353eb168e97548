"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode on the same arrays.

Inputs come from numpy generators with fixed seeds and go to both
packages as numpy arrays.  Tolerances and why:
  * K1 sweep: max|dx| <= 1e-5 max(1, ||x||_inf) and ||dr|| <= 1e-5 ||r||
    after one sweep, 1e-4 after ten: the f32 sums run in another order, and
    Gauss-Seidel carries each block's rounding into the next;
  * K2 / K3: 1e-5 relative to ||A||_F ||x|| (one f32 pass over A);
  * K4: rtol 1e-4 (48 power iterations from the same start vector).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
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
    block_steps,
    sweep_t,
    to_tblock_major,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu_torch.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    k3_depth,
    neg_at_r_t,
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
                            block=B)
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


def test_k3_depth_and_witness_gamma():
    eps = float(np.finfo(np.float32).eps)
    assert k3_depth(10_000) == 16
    assert k3_depth(2048) == 12 and k3_depth(2049) == 13
    for m in (8, 200, 10_000, 20_000, 50_000, 10**6):
        jax_gamma = (np.ceil(np.log2(max(m, 2))) + 4) * eps
        g = witness_gamma(m)
        assert g >= jax_gamma                  # never looser than JAX's
        assert g >= k3_depth(m) * eps / 2      # covers K3's depth (D u)
    # at the headline size the depth fits the JAX package's margin
    assert witness_gamma(10_000) == (np.ceil(np.log2(10_000)) + 4) * eps


def test_jax_runs_on_cpu_here():
    # the JAX references above ran on the CPU backend (interpret mode)
    assert jax.default_backend() == "cpu"


def test_ctypes_declarations_match_the_c_entry_points():
    """Every extern "C" entry point in csrc/ is declared to ctypes with as
    many argument types as its C signature has parameters (ctypes passes
    surplus arguments through unchecked, so a missing one is a crash on the
    card, not an error)."""
    import re
    import types

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    lib = FakeLib()
    _build._declare(lib)
    sig = re.compile(r"^(?:int|const char\*) (cot_\w+)\(([^)]*)\)\s*\{",
                     re.M)
    found = {}
    for src in _build.sources():
        with open(src) as f:
            for name, params in sig.findall(f.read()):
                found[name] = len([p for p in params.split(",") if p.strip()])
    assert len(found) >= 10
    for name, n_params in found.items():
        assert len(getattr(lib, name).argtypes) == n_params, name
