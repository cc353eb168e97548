"""The port's instance generators, config grid and instance store against
the JAX package's (``core/datagen.py``, ``utils/native.py``).

  * ``BENCH_CONFIGS``: every field of the five configs equals the JAX
    package's, and the CI twins' sizes (ngroups clamped) equal the JAX
    instances' shapes;
  * ``BenchConfig.instance_host`` draws the JAX host generator's numbers:
    A, b, lam1, x* and the support bit-equal to JAX
    ``make_lasso_instance_host`` for the same seed;
  * ``make_lasso_instance`` (drawn by a torch.Generator): unit columns to
    1e-6, the support size, |x*| >= 1 on it, x* >= 0 for nonneg_l1,
    lam1 / lambda_max = lam1_frac to 1e-6, whole groups for group_l2, and
    the same generator state gives the same instance;
  * the store: a JAX ``save_instance`` file loads in the port with A, b,
    lam1, kind, weights, x* and the support bit-equal, and the reverse;
    ``write_matrix`` writes the JAX package's bytes, its NumPy fallback
    too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convex_optimization_tpu.core import datagen as jdg
from convex_optimization_tpu.core.problem import Problem as JProblem
from convex_optimization_tpu.models.penalties import Penalty as JPenalty
from convex_optimization_tpu.utils import native as jnative
from convex_optimization_tpu_torch.core import datagen as pdg
from convex_optimization_tpu_torch.core.objective import lambda_max
from convex_optimization_tpu_torch.utils import native as pnative
from tests.torch_threads import worker_threads  # noqa: F401

NAMES = ("config1", "config2", "config3", "config4", "config5")


@pytest.mark.parametrize("name", NAMES)
def test_bench_configs_equal_the_jax_grid(name):
    j, p = jdg.BENCH_CONFIGS[name], pdg.BENCH_CONFIGS[name]
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(p)] == \
        [f.name for f in dataclasses.fields(j)]


@pytest.mark.parametrize("name", ("config1", "config3", "config4"))
def test_ci_twin_equals_jax_host_instance(name):
    """The CI twin's numbers are the JAX host generator's (and its
    shapes the JAX jax.random twin's)."""
    cfg = pdg.BENCH_CONFIGS[name]
    m, n, ng = cfg.sizes(ci=True)
    jinst = jdg.BENCH_CONFIGS[name].instance(jax.random.PRNGKey(0), ci=True)
    assert jinst.problem.A.shape == (m, n)
    assert jinst.problem.penalty.ngroups == ng
    inst, A, b = cfg.instance_host(3, ci=True, device="cpu")
    jh, jA, jb = jdg.make_lasso_instance_host(
        3, m, n, support_frac=cfg.support_frac, lam1_frac=cfg.lam1_frac,
        lam2=cfg.lam2, penalty_kind=cfg.penalty_kind, ngroups=ng)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(inst.problem.A.numpy(), jA)
    assert float(inst.problem.penalty.lam1) == float(jh.problem.penalty.lam1)
    assert inst.problem.lam2 == jh.problem.lam2
    np.testing.assert_array_equal(inst.x_true.numpy(), np.asarray(jh.x_true))
    np.testing.assert_array_equal(inst.support.numpy(),
                                  np.asarray(jh.support))


def test_instance_f64():
    inst = pdg.BENCH_CONFIGS["config1"].instance(0, ci=True, device="cpu",
                                                 dtype=torch.float64)
    assert inst.problem.dtype == torch.float64
    assert inst.problem.b.dtype == torch.float64


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0), ("nonneg_l1", 0, 1e-3), ("group_l2", 16, 0.0)])
def test_make_lasso_instance(kind, ngroups, lam2):
    m, n = 64, 256
    inst = pdg.make_lasso_instance(
        torch.Generator().manual_seed(5), m, n, penalty_kind=kind,
        ngroups=ngroups, lam2=lam2, lam1_frac=0.2, device="cpu")
    p = inst.problem
    assert p.m == m and p.n == n and p.lam2 == lam2
    np.testing.assert_allclose(
        torch.linalg.vector_norm(p.A, dim=0).numpy(), 1.0, atol=1e-6)
    sup = inst.support.numpy()
    x = inst.x_true.numpy()
    if kind == "group_l2":
        gs = n // ngroups
        assert sup.sum() == round(0.05 * ngroups) * gs
        assert all(g.all() or not g.any() for g in sup.reshape(-1, gs))
    else:
        assert sup.sum() == round(0.05 * n)
    assert np.all(np.abs(x[sup]) >= 1.0) and np.all(x[~sup] == 0)
    if kind == "nonneg_l1":
        assert np.all(x >= 0)
    lmax = float(lambda_max(p.A, p.b, p.penalty.with_lam1(1.0)))
    assert abs(float(p.penalty.lam1) / lmax - 0.2) <= 1e-6
    again = pdg.make_lasso_instance(
        torch.Generator().manual_seed(5), m, n, penalty_kind=kind,
        ngroups=ngroups, lam2=lam2, lam1_frac=0.2, device="cpu")
    assert torch.equal(again.problem.A_t, p.A_t)
    assert torch.equal(again.problem.b, p.b)
    assert torch.equal(again.x_true, inst.x_true)
    assert float(again.problem.penalty.lam1) == float(p.penalty.lam1)
    other = pdg.make_lasso_instance(
        torch.Generator().manual_seed(6), m, n, penalty_kind=kind,
        ngroups=ngroups, device="cpu")
    assert not torch.equal(other.problem.A_t, p.A_t)


def _jax_instance(rng, kind, ngroups, weights):
    m, n = 48, 160
    A = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    x = np.where(rng.random(n) < 0.1, rng.standard_normal(n), 0.0) \
        .astype(np.float32)
    pen = JPenalty(lam1=0.37, kind=kind, ngroups=ngroups,
                   weights=None if weights is None else jnp.asarray(weights))
    return jdg.Instance(
        problem=JProblem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=pen,
                         lam2=0.25),
        x_true=jnp.asarray(x), support=jnp.asarray(x != 0))


def _assert_same(jinst, pinst):
    jp, pp = jinst.problem, pinst.problem
    np.testing.assert_array_equal(pp.A.numpy(), np.asarray(jp.A))
    np.testing.assert_array_equal(pp.b.numpy(), np.asarray(jp.b))
    assert float(pp.penalty.lam1) == float(jp.penalty.lam1)
    assert pp.lam2 == jp.lam2
    assert pp.penalty.kind == jp.penalty.kind
    assert pp.penalty.ngroups == jp.penalty.ngroups
    if jp.penalty.weights is None:
        assert pp.penalty.weights is None
    else:
        np.testing.assert_array_equal(pp.penalty.weights.numpy(),
                                      np.asarray(jp.penalty.weights))
    np.testing.assert_array_equal(pinst.x_true.numpy(),
                                  np.asarray(jinst.x_true))
    np.testing.assert_array_equal(pinst.support.numpy(),
                                  np.asarray(jinst.support))


@pytest.mark.parametrize("kind,ngroups,weighted", [
    ("l1", 0, False), ("nonneg_l1", 0, False), ("group_l2", 20, True)])
def test_instance_store_crosses_packages(kind, ngroups, weighted, tmp_path):
    rng = np.random.default_rng(11)
    w = (0.5 + rng.random(ngroups)).astype(np.float32) if weighted else None
    jinst = _jax_instance(rng, kind, ngroups, w)
    jdg.save_instance(str(tmp_path / "j"), jinst)
    pinst = pdg.load_instance(str(tmp_path / "j"), device="cpu")
    _assert_same(jinst, pinst)
    # the reverse: the port writes, the JAX package reads
    pdg.save_instance(str(tmp_path / "p"), pinst)
    _assert_same(jdg.load_instance(str(tmp_path / "p")), pinst)
    for suffix in (".A", ".b"):
        assert (open(tmp_path / f"j{suffix}", "rb").read()
                == open(tmp_path / f"p{suffix}", "rb").read())


def test_store_fallback_writes_the_same_bytes(tmp_path, monkeypatch):
    a = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    jnative.write_matrix(str(tmp_path / "j"), a)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_build_failed", True)
    pnative.write_matrix(str(tmp_path / "f"), a)
    assert (open(tmp_path / "f", "rb").read()
            == open(tmp_path / "j", "rb").read())
    np.testing.assert_array_equal(pnative.read_matrix(str(tmp_path / "j")),
                                  a)
    np.testing.assert_array_equal(jnative.read_matrix(str(tmp_path / "f")),
                                  a)
    row = np.arange(6, dtype=np.float32)
    pnative.write_matrix(str(tmp_path / "r"), row)
    assert pnative.read_matrix(str(tmp_path / "r")).shape == (1, 6)
