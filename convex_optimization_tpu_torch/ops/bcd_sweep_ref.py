"""Plain Gauss-Seidel block-coordinate sweep — the port's oracle.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_ref.py``.  One sweep
visits every contiguous column block j in ``block_order``:

    g_j   = A_j^T r + lam2 * x_j        # block gradient
    x_j'  = prox_{t_j g}(x_j - t_j g_j) # t_j = step_scale / (L_j + lam2)
    r    += A_j (x_j' - x_j)            # incremental residual update

as a Python loop over blocks on the problem's device.  ``A_j^T`` is rows
j*B .. j*B+B-1 of the (n, m) view of ``A_t``, so any B dividing n works.
"""

from __future__ import annotations

import torch

from convex_optimization_tpu_torch.core.problem import Problem
from convex_optimization_tpu_torch.models.penalties import Penalty


def sweep_blocks(A_rows: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                 steps: torch.Tensor, block_order, penalty: Penalty,
                 lam2: float, keep_mask: torch.Tensor | None = None,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep on tensors: A_rows (n, m) = A^T, steps (n_blocks,) the
    per-block step t_j; returns new (x, r)."""
    n = A_rows.shape[0]
    B = n // steps.shape[0]
    x = x.clone()
    r = r.clone()
    for j in block_order:
        j = int(j)
        sl = slice(j * B, (j + 1) * B)
        Aj_t = A_rows[sl]                      # (B, m) = A_j^T
        xj = x[sl]
        g = torch.mv(Aj_t, r) + lam2 * xj
        t = steps[j]
        xj_new = penalty.prox_block(xj - t * g, t, j, n)
        if keep_mask is not None:
            xj_new = torch.where(keep_mask[sl], xj_new,
                                 torch.zeros_like(xj_new))
        r += torch.mv(Aj_t.T, xj_new - xj)
        x[sl] = xj_new
    return x, r


def bcd_sweep_ref(problem: Problem, x: torch.Tensor, r: torch.Tensor,
                  block_L: torch.Tensor, block_order, *,
                  step_scale: float = 1.0,
                  keep_mask: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep over all column blocks; returns new (x, r).

    block_L:     (n_blocks,) per-block ||A_j||_2^2 (WITHOUT lam2)
    block_order: iterable of block indices (cyclic = range(n_blocks))
    keep_mask:   optional (n,) bool mask; False coordinates are set to 0
    """
    n_blocks = block_L.shape[0]
    if problem.n % n_blocks != 0:
        raise ValueError(f"n={problem.n} not divisible by "
                         f"n_blocks={n_blocks}")
    steps = step_scale / (block_L + problem.lam2)
    return sweep_blocks(problem.A_rows, x, r, steps, block_order,
                        problem.penalty, problem.lam2, keep_mask)
