"""K8: one rank's slab sweep of the column-sharded BCD, with the merge's
payload.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_pallas.py`` as the
column-sharded solver calls it (``parallel/sharded.py`` ``sharded_bcd``
there).  The kernel is ``csrc/sweep_slab.cu`` (its note gives the design):
K1's sweep over a rank's slab of ``A_t`` blocks from the consensus
residual, whose epilogue also writes what the merge all-reduces,

    payload = [r_out - r_in (m,), <x, dx>, <dx, dx>, g(x + dx) - g(x)]

``sweep_slab_t`` is the wrapper and ``sweep_slab_t_plain`` its plain
PyTorch version, which runs for CPU tensors and is the kernel's oracle on
the card.  The TPU wrapper's quiet fall back to the jnp oracle where its
gate fails is not copied: a CUDA slab whose tile does not fit raises
here, and ``parallel.sharded`` sends it to K9 (``ops.bcd_sweep.
sweep_route``).
"""

from __future__ import annotations

import ctypes

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    KIND_CODE,
    _check_operands,
    group_operands,
    sweep_t_plain,
)

#: (device index, B, m) -> cooperative grid size
_grid_cache: dict = {}


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


def slab_grid(device: torch.device, B: int, m: int) -> int:
    """Cooperative grid size of K8 at (B, m) on ``device``; raises when
    the tile does not fit in shared memory."""
    key = (device.index, B, m)
    if key not in _grid_cache:
        lib = _build.load()
        g = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.cot_sweep_slab_grid(B, m, ctypes.byref(g)),
                         "cot_sweep_slab_grid")
        if g.value == 0:
            raise ValueError(f"slab tile of B={B} x m={m} does not fit in "
                             "shared memory")
        _grid_cache[key] = g.value
    return _grid_cache[key]


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
    if penalty.kind not in KIND_CODE:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
    _check_operands(A_t, x, r, steps, keep_mask)
    nb, B, m = A_t.shape
    gsize, w = group_operands(penalty, nb * B, B, A_t.device)
    grid = slab_grid(A_t.device, B, m)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    payload = torch.empty((m + 3,), dtype=torch.float32, device=A_t.device)
    scratch = torch.empty(((grid + 1) * B,), dtype=torch.float32,
                          device=A_t.device)
    err = _build.load().cot_sweep_slab_t(
        A_t.data_ptr(), x.data_ptr(), r.data_ptr(), steps.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        None if w is None else w.data_ptr(),
        x_out.data_ptr(), r_out.data_ptr(), payload.data_ptr(),
        scratch.data_ptr(), nb, B, m, gsize, float(penalty.lam1),
        float(lam2), KIND_CODE[penalty.kind], grid,
        _build.stream_ptr(A_t.device))
    _build.check(err, "sweep_slab_t")
    _build.launches["sweep_slab_t"] += 1
    return x_out, r_out, payload
