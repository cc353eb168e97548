"""Problem container for composite sparse-regression instances.

Counterpart of ``convex_optimization_tpu/core/problem.py``:

    min_x  P(x) = 0.5 * ||A x - b||^2 + (lam2/2) * ||x||^2 + penalty(x)

The stored operand is the transposed block-major ``A_t`` of shape
(n/B, B, m), contiguous: block j holds columns j*B .. j*B+B-1 of A, each
as a contiguous row of length m.  As a flat (n, m) buffer this is A^T in
row-major order whatever B is, so

  * ``A`` (m, n) is a view of it (``A_t.reshape(n, m).T``);
  * another block width is a view too (``with_block``);
  * a column-major host matrix (``A = G.T`` with G (n, m) C-ordered, as
    ``core/datagen.py`` makes it) becomes ``A_t`` without a relayout.

The device is the device of ``A_t``; every solver runs there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from convex_optimization_tpu_torch.models.penalties import (
    Penalty,
    group_l2,
    l1,
    nonneg_l1,
)
from convex_optimization_tpu_torch.utils.device import require_cuda


@dataclasses.dataclass(frozen=True)
class Problem:
    """A dense composite problem instance.

    A_t: (n/B, B, m) contiguous transposed block-major design matrix
    b: (m,) observations
    penalty: nonsmooth part g
    lam2: ridge coefficient of the smooth part (elastic net when > 0)
    """

    A_t: torch.Tensor
    b: torch.Tensor
    penalty: Penalty
    lam2: float = 0.0

    def __post_init__(self):
        if self.A_t.dim() != 3 or not self.A_t.is_contiguous():
            raise ValueError("A_t must be a contiguous (n/B, B, m) tensor")
        if self.b.shape != (self.m,):
            raise ValueError(f"b has shape {tuple(self.b.shape)}, "
                             f"expected ({self.m},)")

    @property
    def m(self) -> int:
        return self.A_t.shape[2]

    @property
    def n(self) -> int:
        return self.A_t.shape[0] * self.A_t.shape[1]

    @property
    def block(self) -> int:
        return self.A_t.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.A_t.dtype

    @property
    def device(self) -> torch.device:
        return self.A_t.device

    @property
    def A_rows(self) -> torch.Tensor:
        """A^T as a contiguous (n, m) view: row k is column k of A."""
        return self.A_t.view(self.n, self.m)

    @property
    def A(self) -> torch.Tensor:
        """The (m, n) design matrix, a (column-major) view of ``A_t``."""
        return self.A_rows.T

    def with_block(self, block: int) -> "Problem":
        """The same problem viewed with block width ``block`` (no copy)."""
        if self.n % block:
            raise ValueError(f"block {block} does not divide n={self.n}")
        return dataclasses.replace(
            self, A_t=self.A_t.view(self.n // block, block, self.m))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """r = A x - b (the dual machinery uses rho = -r)."""
        return torch.mv(self.A, x) - self.b

    def col_norms(self) -> torch.Tensor:
        """Augmented per-column norms sqrt(||A_j||^2 + lam2)."""
        sq = torch.linalg.vector_norm(self.A_rows, dim=1) ** 2
        return torch.sqrt(sq + self.lam2)

    def with_penalty(self, penalty: Penalty) -> "Problem":
        return dataclasses.replace(self, penalty=penalty)

    def with_lam1(self, lam1) -> "Problem":
        return dataclasses.replace(self, penalty=self.penalty.with_lam1(lam1))


def default_block(n: int, target: int = 128) -> int:
    """Largest divisor of n that is <= target (the storage block width;
    solvers re-view the problem with the width they need)."""
    return max(d for d in range(1, min(n, target) + 1) if n % d == 0)


def make_penalty(kind: str, lam1, ngroups: int = 0,
                 weights=None, device=None) -> Penalty:
    if kind == "l1":
        return l1(lam1)
    if kind == "nonneg_l1":
        return nonneg_l1(lam1)
    if kind == "group_l2":
        w = None
        if weights is not None:
            w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                                device=device)
        return group_l2(lam1, ngroups, w)
    raise ValueError(f"unknown penalty kind {kind!r}")


def make_problem(A: torch.Tensor, b: torch.Tensor, lam1, *, lam2=0.0,
                 penalty: Penalty | None = None,
                 block: int | None = None) -> Problem:
    """Problem from an (m, n) tensor A (one transposing copy); defaults to
    the lasso penalty."""
    m, n = A.shape
    block = default_block(n) if block is None else block
    A_t = A.T.contiguous().view(n // block, block, m)
    penalty = l1(lam1) if penalty is None else penalty.with_lam1(lam1)
    return Problem(A_t=A_t, b=b, penalty=penalty, lam2=float(lam2))


def problem_from_numpy(A: np.ndarray, b: np.ndarray, penalty_kind: str,
                       lam1: float, lam2: float = 0.0, ngroups: int = 0,
                       weights=None, *, block: int | None = None,
                       device=None) -> Problem:
    """The port's Problem from the numpy arrays the JAX package was given.

    A is (m, n) float32.  When A is column-major (``A.T`` C-contiguous, as
    the host generators make it) ``A_t`` is a view of that buffer on the
    CPU and one upload to another device; otherwise one transposing copy
    is made first.  ``block`` defaults to ``default_block(n)``; ``device``
    to the card (``require_cuda``): a CPU problem is asked for with
    ``device="cpu"``."""
    A = np.asarray(A)
    if A.dtype != np.float32:
        raise ValueError(f"A must be float32, got {A.dtype}")
    m, n = A.shape
    block = default_block(n) if block is None else block
    if n % block:
        raise ValueError(f"block {block} does not divide n={n}")
    if device is None:
        device = require_cuda()
    At2 = np.ascontiguousarray(A.T)          # a view when A is F-ordered
    A_t = torch.from_numpy(At2).view(n // block, block, m).to(device)
    b_t = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device)
    pen = make_penalty(penalty_kind, float(lam1), ngroups, weights, device)
    return Problem(A_t=A_t, b=b_t, penalty=pen, lam2=float(lam2))
