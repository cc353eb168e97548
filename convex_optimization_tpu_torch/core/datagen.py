"""Synthetic lasso instances, the benchmark config grid and the instance
store.

Counterpart of ``convex_optimization_tpu/core/datagen.py``:

  * ``make_lasso_instance_host``, with the JAX package's arithmetic, so
    one seed gives both packages the same A, b and lam1: a dense Gaussian
    A from the native threaded generator, unit-norm columns, a planted
    sparse x* with |x*| >= 1, b = A x* + noise, and lam1 = lam1_frac *
    lam_max.  A is generated as G (n, m) C-ordered and returned as the
    column-major view ``A = G.T``; the port's ``A_t`` is ``G`` reshaped to
    (n/B, B, m), so the device holds exactly one copy of the matrix and
    the upload needs no relayout;
  * ``make_lasso_instance``, the same recipe drawn by a
    ``torch.Generator`` (the JAX package draws it by ``jax.random``,
    whose numbers torch cannot reproduce);
  * ``BenchConfig`` / ``BENCH_CONFIGS``, the five contract configurations
    of ``BASELINE.json`` (lines 7-11) with their CI-sized twins, field for
    field as the JAX package states them; their instances are drawn by
    the host generator;
  * ``save_instance`` / ``load_instance``: ``<path>.A``, ``<path>.b``
    (``utils/native`` store) and ``<path>.meta.npz``, the JAX package's
    layout and keys, so a file written by one package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.objective import lambda_max
from convex_optimization_tpu_torch.core.problem import (
    Problem,
    make_penalty,
    make_problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.utils import native
from convex_optimization_tpu_torch.utils.device import require_cuda


class Instance(NamedTuple):
    problem: Problem
    x_true: torch.Tensor     # planted coefficients
    support: torch.Tensor    # boolean planted support mask


def make_lasso_instance(
    generator: torch.Generator,
    m: int,
    n: int,
    *,
    support_frac: float = 0.05,
    noise_std: float = 0.01,
    lam1_frac: float = 0.1,
    lam2: float = 0.0,
    penalty_kind: str = "l1",
    ngroups: int = 0,
    dtype: torch.dtype = torch.float32,
    normalize_columns: bool = True,
    device=None,
) -> Instance:
    """Dense Gaussian A (m x n), planted sparse x*, b = A x* + noise, lam1
    = lam1_frac * lambda_max, every number drawn from ``generator`` on its
    own device.  The arithmetic is the JAX package's
    ``make_lasso_instance``: unit columns; a support of round(support_frac
    * n) columns (for group_l2 with ngroups > 0: of whole groups) drawn
    without replacement; values z + sign(z) (|x*| >= 1), made
    nonnegative for nonneg_l1.  ``device`` defaults to the card."""
    if device is None:
        device = require_cuda()
    gdev = generator.device
    A = torch.randn((m, n), generator=generator, dtype=dtype, device=gdev)
    if normalize_columns:
        A /= torch.linalg.vector_norm(A, dim=0, keepdim=True)
    if penalty_kind == "group_l2" and ngroups > 0:
        gsize = n // ngroups
        ng_nz = max(1, int(round(support_frac * ngroups)))
        gidx = torch.randperm(ngroups, generator=generator,
                              device=gdev)[:ng_nz]
        idx = (gidx[:, None] * gsize
               + torch.arange(gsize, device=gdev)[None, :]).reshape(-1)
    else:
        nnz = max(1, int(round(support_frac * n)))
        idx = torch.randperm(n, generator=generator, device=gdev)[:nnz]
    support = torch.zeros((n,), dtype=torch.bool, device=gdev)
    support[idx] = True
    z = torch.randn((idx.numel(),), generator=generator, dtype=dtype,
                    device=gdev)
    x_true = torch.zeros((n,), dtype=dtype, device=gdev)
    x_true[idx] = z + torch.sign(z)
    if penalty_kind == "nonneg_l1":
        x_true = torch.abs(x_true)
    b = A @ x_true
    if noise_std > 0:
        b = b + noise_std * torch.randn((m,), generator=generator,
                                        dtype=dtype, device=gdev)
    if penalty_kind == "group_l2" and (ngroups <= 0 or n % ngroups):
        raise ValueError("group_l2 requires ngroups dividing n")
    pen = make_penalty(penalty_kind, 1.0, ngroups)
    lam1 = lam1_frac * float(lambda_max(A, b, pen))
    A, b = A.to(device), b.to(device)
    problem = make_problem(A, b, lam1, lam2=lam2, penalty=pen)
    return Instance(problem=problem, x_true=x_true.to(device),
                    support=support.to(device))


def make_lasso_instance_host(
    seed: int,
    m: int,
    n: int,
    *,
    support_frac: float = 0.05,
    noise_std: float = 0.01,
    lam1_frac: float = 0.1,
    lam2: float = 0.0,
    penalty_kind: str = "l1",
    ngroups: int = 0,
    normalize_columns: bool = True,
    device=None,
    block: int | None = None,
):
    """Returns ``(Instance, A_np, b_np)``: the numpy copies let the host
    polish phase read columns without fetching A back from the device.
    ``device`` defaults to the card (``require_cuda``); a CPU instance is
    asked for with ``device="cpu"``."""
    if device is None:
        device = require_cuda()
    A = native.gaussian((n, m), seed=seed).T
    if normalize_columns:
        A /= np.linalg.norm(A, axis=0, keepdims=True)

    rng = np.random.default_rng(seed + 1)
    if penalty_kind == "group_l2" and ngroups > 0:
        gsize = n // ngroups
        ng_nz = max(1, int(round(support_frac * ngroups)))
        gidx = rng.choice(ngroups, size=ng_nz, replace=False)
        idx = (gidx[:, None] * gsize
               + np.arange(gsize)[None, :]).reshape(-1)
        nnz = idx.shape[0]
    else:
        nnz = max(1, int(round(support_frac * n)))
        idx = rng.choice(n, size=nnz, replace=False)
    support = np.zeros(n, bool)
    support[idx] = True
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals += np.sign(vals)      # |x*| >= 1
    x_true = np.zeros(n, np.float32)
    x_true[idx] = vals
    if penalty_kind == "nonneg_l1":
        x_true = np.abs(x_true)

    b = A @ x_true
    if noise_std > 0:
        b = b + noise_std * rng.standard_normal(m).astype(np.float32)

    if penalty_kind == "l1":
        raw = float(np.max(np.abs(A.T @ b)))
    elif penalty_kind == "nonneg_l1":
        raw = float(max(np.max(A.T @ b), 0.0))
    elif penalty_kind == "group_l2":
        if ngroups <= 0 or n % ngroups != 0:
            raise ValueError("group_l2 requires ngroups dividing n")
        gn = np.linalg.norm((A.T @ b).reshape(ngroups, -1), axis=1)
        raw = float(np.max(gn))
    else:
        raise ValueError(f"unknown penalty kind {penalty_kind!r}")

    problem = problem_from_numpy(A, b, penalty_kind, lam1_frac * raw,
                                 lam2=lam2, ngroups=ngroups, block=block,
                                 device=device)
    inst = Instance(problem=problem,
                    x_true=torch.from_numpy(x_true).to(device),
                    support=torch.from_numpy(support).to(device))
    return inst, A, b


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One row of the BASELINE.md benchmark grid (+ a CI-sized twin), the
    JAX package's ``BenchConfig`` field for field."""

    name: str
    m: int
    n: int
    penalty_kind: str = "l1"
    lam2: float = 0.0
    ngroups: int = 0
    lam1_frac: float = 0.1
    support_frac: float = 0.05
    lambda_path: int = 0        # >0: warm-started geometric path of this length
    screening: bool = False
    sharded: bool = False       # column-shard A over the mesh
    ci_m: int = 128             # CI twin sizes
    ci_n: int = 512

    def sizes(self, ci: bool = False) -> tuple[int, int, int]:
        """(m, n, ngroups); the CI twin clamps ngroups to n // 4, as the
        JAX package does."""
        m, n = (self.ci_m, self.ci_n) if ci else (self.m, self.n)
        ngroups = self.ngroups
        if ci and ngroups:
            ngroups = min(ngroups, n // 4)
        return m, n, ngroups

    def instance_host(self, seed: int, *, ci: bool = False, device=None,
                      dtype: torch.dtype = torch.float32):
        """``(Instance, A_np, b_np)`` drawn by ``make_lasso_instance_host``
        (the JAX host generator's numbers) on ``device`` (default: the
        card); ``dtype=torch.float64`` casts the problem, while A_np and
        b_np stay the f32 data."""
        m, n, ngroups = self.sizes(ci)
        inst, A_np, b_np = make_lasso_instance_host(
            seed, m, n, support_frac=self.support_frac,
            lam1_frac=self.lam1_frac, lam2=self.lam2,
            penalty_kind=self.penalty_kind, ngroups=ngroups, device=device)
        if dtype != torch.float32:
            inst = inst._replace(problem=inst.problem.to(dtype=dtype),
                                 x_true=inst.x_true.to(dtype))
        return inst, A_np, b_np

    def instance(self, seed: int, *, ci: bool = False, device=None,
                 dtype: torch.dtype = torch.float32) -> Instance:
        return self.instance_host(seed, ci=ci, device=device, dtype=dtype)[0]


# The five contract configs (BASELINE.json lines 7-11; see BASELINE.md).
BENCH_CONFIGS = {
    # Config 1: dense lasso 500x2000, 5% support, lam = 0.1 lam_max
    "config1": BenchConfig(name="config1", m=500, n=2000),
    # Config 2: dense lasso 5k x 50k, FISTA + warm-started 10-value lambda path
    "config2": BenchConfig(name="config2", m=5_000, n=50_000, lambda_path=10),
    # Config 3: elastic-net + nonnegative lasso, 10k x 100k, screening on
    "config3": BenchConfig(
        name="config3", m=10_000, n=100_000, penalty_kind="nonneg_l1",
        lam2=1e-3, screening=True,
    ),
    # Config 4: group lasso, 1k blocks, 20k x 200k, blockwise prox / sharded cols
    "config4": BenchConfig(
        name="config4", m=20_000, n=200_000, penalty_kind="group_l2",
        ngroups=1000, sharded=True,
    ),
    # Config 5: 50k x 1M column-sharded, psum residual consensus per sweep
    "config5": BenchConfig(
        name="config5", m=50_000, n=1_000_000, sharded=True,
    ),
}


def save_instance(path: str, inst: Instance) -> None:
    """Persist an instance: ``<path>.A`` and ``<path>.b`` through the
    native store (f32), ``<path>.meta.npz`` with the JAX package's keys
    (lam1, lam2, kind, ngroups, weights, x_true, support)."""
    prob = inst.problem
    native.write_matrix(path + ".A", prob.A.detach().cpu().numpy())
    native.write_matrix(path + ".b", prob.b.detach().cpu().numpy())
    pen = prob.penalty
    np.savez(
        path + ".meta.npz",
        lam1=np.float64(float(pen.lam1)),
        lam2=np.float64(prob.lam2),
        kind=np.frombuffer(pen.kind.encode(), dtype=np.uint8),
        ngroups=np.int64(pen.ngroups),
        weights=(np.zeros(0) if pen.weights is None
                 else pen.weights.detach().cpu().numpy()),
        x_true=inst.x_true.detach().cpu().numpy(),
        support=inst.support.detach().cpu().numpy(),
    )


def load_instance(path: str, *, device=None) -> Instance:
    """An instance written by ``save_instance`` (either package's), on
    ``device`` (default: the card)."""
    if device is None:
        device = require_cuda()
    A = native.read_matrix(path + ".A")
    b = native.read_matrix(path + ".b").reshape(-1)
    with np.load(path + ".meta.npz") as z:
        kind = bytes(z["kind"].tobytes()).decode()
        weights = z["weights"]
        problem = problem_from_numpy(
            A, b, kind, float(z["lam1"]),
            lam2=float(z["lam2"]), ngroups=int(z["ngroups"]),
            weights=None if weights.size == 0 else weights, device=device)
        return Instance(problem=problem,
                        x_true=torch.from_numpy(z["x_true"]).to(device),
                        support=torch.from_numpy(z["support"]).to(device))
