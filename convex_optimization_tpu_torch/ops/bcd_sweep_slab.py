"""K8: one rank's slab sweep of the column-sharded BCD, with the merge's
payload.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_pallas.py`` as the
column-sharded solver calls it (``parallel/sharded.py`` ``sharded_bcd``
there): K1's sweep over a rank's slab of ``A_t`` blocks from the consensus
residual, which also writes what the merge all-reduces,

    payload = [r_out - r_in (m,), <x, dx>, <dx, dx>, g(x + dx) - g(x)]

``sweep_slab_t`` is the wrapper and ``sweep_slab_t_plain`` its plain
PyTorch version, which runs for CPU tensors and is the kernel's oracle on
the card.  The kernel is K1's payload instance (``csrc/sweep.cu``,
launched by ``ops.bcd_sweep.launch`` on K1's plan ``sweep_plan``), so its
x and r are K1's bit for bit.  The TPU wrapper's quiet fall back to the
jnp oracle where its gate fails is not copied: a CUDA slab whose tile does
not fit raises here, and ``parallel.sharded`` sends it to K9
(``ops.bcd_sweep.sweep_route``).
"""

from __future__ import annotations

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops.bcd_sweep import launch, sweep_t_plain


def merge_payload(x: torch.Tensor, x_out: torch.Tensor, r_in: torch.Tensor,
                  r_out: torch.Tensor, penalty: Penalty) -> torch.Tensor:
    """The merge's payload of a slab sweep, as tensor ops (the plain
    version, and the K9 route's epilogue)."""
    dx = x_out - x
    tail = torch.stack([torch.dot(x, dx), torch.dot(dx, dx),
                        torch.as_tensor(penalty.value_diff(x, dx),
                                        dtype=x.dtype, device=x.device)])
    return torch.cat([r_out - r_in, tail])


def sweep_slab_t_plain(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                       steps: torch.Tensor, keep_mask: torch.Tensor | None,
                       penalty: Penalty, lam2: float,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: K1's plain sweep, then the payload."""
    x_out, r_out = sweep_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    return x_out, r_out, merge_payload(x, x_out, r, r_out, penalty)


def sweep_slab_t(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                 steps: torch.Tensor, keep_mask: torch.Tensor | None,
                 penalty: Penalty, lam2: float,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cyclic sweep over the slab A_t (nb_loc, B, m) from r (m,) =
    the consensus residual; returns (x_out, r_out, payload (m + 3,)).

    Operands as ``ops.bcd_sweep.sweep_t``, with the slab's own penalty
    (its group weights).  CPU tensors take the plain version; CUDA tensors
    launch K8 or raise."""
    if A_t.device.type == "cpu":
        return sweep_slab_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    payload = torch.empty((A_t.shape[2] + 3,), dtype=torch.float32,
                          device=A_t.device)
    x_out, r_out = launch("sweep_slab_t", A_t, x, r, steps, keep_mask,
                          penalty, lam2, payload)
    return x_out, r_out, payload
