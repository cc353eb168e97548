"""Host-side synthetic lasso instances.

Counterpart of ``make_lasso_instance_host`` in
``convex_optimization_tpu/core/datagen.py``, with the same arithmetic, so
one seed gives both packages the same A, b and lam1: a dense Gaussian A
from the native threaded generator, unit-norm columns, a planted sparse
x* with |x*| >= 1, b = A x* + noise, and lam1 = lam1_frac * lam_max.

A is generated as G (n, m) C-ordered and returned as the column-major
view ``A = G.T``; the port's ``A_t`` is ``G`` reshaped to (n/B, B, m), so
the device holds exactly one copy of the matrix and the upload needs no
relayout.

``CONFIGS`` holds contract configurations as the JAX package's
``BENCH_CONFIGS`` (``BASELINE.json`` lines 7-11) states them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.core.problem import (
    Problem,
    problem_from_numpy,
)
from convex_optimization_tpu_torch.utils import native
from convex_optimization_tpu_torch.utils.device import require_cuda


class Instance(NamedTuple):
    problem: Problem
    x_true: torch.Tensor     # planted coefficients
    support: torch.Tensor    # boolean planted support mask


#: make_lasso_instance_host arguments of contract configurations (the JAX
#: package's core/datagen.py BENCH_CONFIGS, at 5 % support and lam1 =
#: 0.1 lam_max); the seed is the one its scripts use
CONFIGS = {
    # config 4: group lasso, 1000 contiguous groups of 200, 20k x 200k
    "config4": dict(seed=0, m=20_000, n=200_000, penalty_kind="group_l2",
                    ngroups=1000),
}


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
