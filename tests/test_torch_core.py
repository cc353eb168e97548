"""The port's core modules (penalties, problem, objective, datagen, native
binding, block choice) against the JAX package on the same numpy arrays,
plus the package rules (no jax import, precision flags).

Tolerance: rtol 1e-6 for the elementwise penalty and gap arithmetic (the
same f32 operations, only their order may differ); exact equality where
both packages run the same host code (datagen, native generator).
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convex_optimization_tpu as co
from convex_optimization_tpu.core.datagen import (
    make_lasso_instance_host as j_make_host,
)
from convex_optimization_tpu.core.objective import (
    gap_from_parts as j_gap_from_parts,
)
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.ops.bcd_sweep_vpu import (
    pick_padded_block_size_vpu,
)
from convex_optimization_tpu.utils import native as j_native
import convex_optimization_tpu_torch as cot
from convex_optimization_tpu_torch.core.datagen import (
    make_lasso_instance_host,
)
from convex_optimization_tpu_torch.core.objective import (
    duality_gap,
    gap_from_parts,
    lambda_max,
)
from convex_optimization_tpu_torch.core.problem import (
    default_block,
    make_problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
from convex_optimization_tpu_torch.utils import native

PORT_DIR = pathlib.Path(cot.__file__).parent

KINDS = [("l1", 0, None), ("nonneg_l1", 0, None),
         ("group_l2", 16, np.linspace(0.5, 2.0, 16))]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _penalties(kind, ngroups, weights, lam1=0.37):
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    tw = None if weights is None else torch.tensor(weights,
                                                   dtype=torch.float32)
    return (JPenalty(lam1=lam1, kind=kind, ngroups=ngroups, weights=jw),
            Penalty(lam1=lam1, kind=kind, ngroups=ngroups, weights=tw))


def _close(t, j, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind,ngroups,weights", KINDS)
def test_penalty_matches_jax(kind, ngroups, weights):
    rng = np.random.default_rng(1)
    v = rng.standard_normal(128).astype(np.float32)
    jpen, tpen = _penalties(kind, ngroups, weights)
    tv = torch.from_numpy(v)
    _close(tpen.value(tv), jpen.value(jnp.asarray(v)))
    _close(tpen.dual_norm(tv), jpen.dual_norm(jnp.asarray(v)))
    _close(tpen.prox(tv, 0.7), jpen.prox(jnp.asarray(v), 0.7), atol=1e-7)
    # one block of 32 coordinates (two groups of 8 for group_l2 at n=128)
    blk = v[32:64]
    _close(tpen.prox_block(torch.from_numpy(blk), 0.7, 1, 128),
           jpen.prox_block(jnp.asarray(blk), 0.7, 1, 128), atol=1e-7)
    _close(tpen.with_lam1(2.0).lam1, 2.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_from_parts_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rho_b, aug, g, dn = (rng.uniform(0.1, 10.0, 4)).astype(np.float32)
    got = gap_from_parts(*(torch.tensor(v) for v in (rho_b, aug, g, dn)))
    want = j_gap_from_parts(*(jnp.asarray(v) for v in (rho_b, aug, g, dn)))
    for a, b in zip(got, want):
        _close(a, b)


def _instance(kind, ngroups, weights, m=64, n=256, lam2=0.2, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32).T
    b = rng.standard_normal(m).astype(np.float32)
    x = np.where(rng.random(n) < 0.2, rng.standard_normal(n), 0.0)
    x = x.astype(np.float32)
    if kind == "nonneg_l1":
        x = np.abs(x)
    jpen, _ = _penalties(kind, ngroups, weights)
    jp = co.Problem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=jpen,
                    lam2=lam2)
    tp = problem_from_numpy(A, b, kind, 0.37, lam2, ngroups, weights,
                            block=32, device="cpu")
    return jp, tp, x


@pytest.mark.parametrize("kind,ngroups,weights", KINDS)
def test_duality_gap_matches_jax(kind, ngroups, weights):
    jp, tp, x = _instance(kind, ngroups, weights)
    got = duality_gap(tp, torch.from_numpy(x))
    want = co.duality_gap(jp, jnp.asarray(x))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5)
    got64 = duality_gap(tp, torch.from_numpy(x), precise=True)
    want64 = co.duality_gap(jp, jnp.asarray(x), precise=True)
    assert got64.rel_gap.dtype == torch.float64
    for a, b in zip(got64, want64):
        _close(a, b, rtol=1e-12)


def test_lambda_max_matches_jax():
    jp, tp, _ = _instance("l1", 0, None)
    _close(lambda_max(tp.A, tp.b, tp.penalty),
           co.lambda_max(jp.A, jp.b, jp.penalty))


def test_problem_from_numpy_round_trip():
    rng = np.random.default_rng(4)
    m, n = 48, 240
    G = rng.standard_normal((n, m)).astype(np.float32)
    A = G.T                                    # column-major, as datagen
    b = rng.standard_normal(m).astype(np.float32)
    p = problem_from_numpy(A, b, "l1", 0.5, block=40, device="cpu")
    assert p.A_t.shape == (6, 40, m) and p.block == 40
    assert (p.m, p.n) == (m, n) and p.dtype == torch.float32
    # A_t is a view of the transposed host buffer, A a view of A_t
    assert np.shares_memory(p.A_t.numpy(), G)
    np.testing.assert_array_equal(p.A.numpy(), A)
    np.testing.assert_array_equal(p.A_t.numpy()[2, 5], A[:, 2 * 40 + 5])
    # another block width is a view of the same buffer
    q = p.with_block(80)
    assert q.A_t.shape == (3, 80, m)
    assert q.A_t.data_ptr() == p.A_t.data_ptr()
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(p.residual(torch.from_numpy(x)).numpy(),
                               A @ x - b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.col_norms().numpy(),
                               np.linalg.norm(A, axis=0), rtol=1e-6)
    # a C-ordered A is copied once, with the same values
    pc = problem_from_numpy(np.ascontiguousarray(A), b, "nonneg_l1", 0.5,
                            lam2=0.1, block=40, device="cpu")
    np.testing.assert_array_equal(pc.A_t.numpy(), p.A_t.numpy())
    assert pc.penalty.kind == "nonneg_l1" and pc.lam2 == 0.1
    with pytest.raises(ValueError):
        problem_from_numpy(A, b, "l1", 0.5, block=7, device="cpu")
    with pytest.raises(ValueError):
        problem_from_numpy(A.astype(np.float64), b, "l1", 0.5, device="cpu")
    # make_problem: from a tensor, default block = largest divisor <= 128
    mp = make_problem(torch.from_numpy(np.ascontiguousarray(A)),
                      torch.from_numpy(b), 0.5)
    assert mp.block == default_block(n) == 120
    np.testing.assert_array_equal(mp.A.numpy(), A)


def test_host_instance_matches_jax():
    for kind in ("l1", "nonneg_l1"):
        inst, A, b = make_lasso_instance_host(7, 64, 320, penalty_kind=kind,
                                              device="cpu")
        j_inst, jA, jb = j_make_host(7, 64, 320, penalty_kind=kind)
        np.testing.assert_array_equal(A, jA)
        np.testing.assert_array_equal(b, jb)
        assert inst.problem.penalty.lam1 == float(j_inst.problem.penalty.lam1)
        np.testing.assert_array_equal(inst.x_true.numpy(),
                                      np.asarray(j_inst.x_true))
        np.testing.assert_array_equal(inst.support.numpy(),
                                      np.asarray(j_inst.support))
        assert np.shares_memory(inst.problem.A_t.numpy(), A)


def test_native_binding_matches_jax_package():
    assert native.have_native()
    assert native.library_path().endswith(".so")
    np.testing.assert_array_equal(native.gaussian((5, 7), seed=11),
                                  j_native.gaussian((5, 7), seed=11))
    rng = np.random.default_rng(2)
    As = np.asfortranarray(rng.standard_normal((30, 12)).astype(np.float32))
    r = rng.standard_normal(30)
    xs = np.where(rng.random(12) < 0.5, rng.standard_normal(12), 0.0)
    b = rng.standard_normal(30)
    idx = np.array([3, 0, 7])
    np.testing.assert_array_equal(native.gather_cols(As, idx, np.float32),
                                  j_native.gather_cols(As, idx, np.float32))
    np.testing.assert_allclose(native.atr_mixed(As, r, 0.1, xs),
                               -(As.astype(np.float64).T @ r) - 0.1 * xs,
                               rtol=1e-12)
    np.testing.assert_allclose(native.ax_sparse(As, xs, b),
                               As.astype(np.float64) @ xs - b, rtol=1e-12)
    with pytest.raises(IndexError):
        native.gather_cols(As, np.array([12]), np.float32)


@pytest.mark.parametrize("m,n,target", [
    (200, 800, 40), (200, 800, 128), (10_000, 100_000, 128), (64, 1024, 128),
    (128, 804, 128), (96, 1000, 64), (256, 4096, 128), (64, 100, 128),
])
def test_block_choice_matches_jax(m, n, target):
    assert pick_block_size_t(n, target) == \
        pick_padded_block_size_vpu(m, n, target)
    assert pick_block_size_t(100_000, 128) == (80, 0)


def test_group_block_choice_matches_jax():
    # group size 12: B must be a multiple of lcm(8, 12) = 24
    assert pick_block_size_t(960, 128, 12) == \
        pick_padded_block_size_vpu(64, 960, 128, 12)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent /
                                              "chip_smoke.py"]
    assert len(files) >= 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "convex_optimization_tpu"), \
                (f, mod)


def test_port_modules_name_their_jax_counterparts():
    for f in PORT_DIR.rglob("*.py"):
        if f.name in ("__init__.py", "_build.py", "device.py"):
            continue
        doc = ast.get_docstring(ast.parse(f.read_text())) or ""
        assert "convex_optimization_tpu/" in doc, f


def test_precision_flags_set_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_require_cuda():
    if torch.cuda.is_available():
        assert cot.require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cot.require_cuda()
