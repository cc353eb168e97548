"""K9: the streamed Gauss-Seidel sweep, for blocks too wide for K1's tile.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_pallas_tiled.py``.
The kernel is ``csrc/sweep_tiled.cu`` (its note gives the design): the same
sweep as K1 over the same layout ``A_t`` (n/B, B, m), with each CTA's
(B x rows) slab streamed through shared memory twice per block instead of
held there.  The TPU kernel's block-major copy of A is not made: a
coordinate's rows are already one contiguous run in ``A_t``.

``sweep_tiled_t`` is the wrapper and ``sweep_tiled_t_plain`` its plain
PyTorch version (the same loop as K1's), which runs for CPU tensors and is
the kernel's oracle on the card.  ``ops.bcd_sweep.sweep_route`` says which
of K1 and K9 takes a block.
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

#: (device index, B, m, vec) -> (grid, rows, chunk) of the cooperative launch
_plan_cache: dict = {}


def sweep_tiled_t_plain(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                        steps: torch.Tensor, keep_mask: torch.Tensor | None,
                        penalty: Penalty, lam2: float,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: the same sweep as K1's, block by block."""
    return sweep_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)


def copy_width(A_t: torch.Tensor) -> int:
    """Floats per cp.async copy: 4 (16 bytes) where every coordinate's run
    starts 16-byte aligned, else 1."""
    return 4 if A_t.shape[2] % 4 == 0 and A_t.data_ptr() % 16 == 0 else 1


def tiled_plan(device: torch.device, B: int, m: int,
               vec: int = 4) -> tuple[int, int, int]:
    """(grid, rows per CTA, coordinates per streamed chunk) of K9 at
    (B, m) on ``device``; raises when even one coordinate's run does not
    fit the shared-memory ring."""
    key = (device.index, B, m, vec)
    if key not in _plan_cache:
        lib = _build.load()
        plan = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            _build.check(lib.cot_sweep_tiled_plan(B, m, vec, plan),
                         "cot_sweep_tiled_plan")
        if plan[0] == 0:
            raise ValueError(f"K9 ring of B={B} x m={m} does not fit in "
                             "shared memory")
        _plan_cache[key] = (plan[0], plan[1], plan[2])
    return _plan_cache[key]


def sweep_tiled_t(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                  steps: torch.Tensor, keep_mask: torch.Tensor | None,
                  penalty: Penalty, lam2: float,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cyclic sweep, A streamed twice; returns new (x, r).

    Operands as ``ops.bcd_sweep.sweep_t``: A_t (n_blocks, B, m) f32; x (n,),
    r (m,) = A x - b, steps (n_blocks,) t_j = step_scale / (L_j + lam2);
    keep_mask None or (n,) bool; a group_l2 block holds whole groups.  CPU
    tensors take the plain version; CUDA tensors launch K9 or raise."""
    if A_t.device.type == "cpu":
        return sweep_tiled_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    if penalty.kind not in KIND_CODE:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
    _check_operands(A_t, x, r, steps, keep_mask)
    nb, B, m = A_t.shape
    gsize, w = group_operands(penalty, nb * B, B, A_t.device)
    vec = copy_width(A_t)
    grid, rows, chunk = tiled_plan(A_t.device, B, m, vec)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    scratch = torch.empty(((grid + 1) * B,), dtype=torch.float32,
                          device=A_t.device)
    err = _build.load().cot_sweep_tiled_t(
        A_t.data_ptr(), x.data_ptr(), r.data_ptr(), steps.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        None if w is None else w.data_ptr(),
        x_out.data_ptr(), r_out.data_ptr(), scratch.data_ptr(),
        nb, B, m, gsize, float(penalty.lam1), float(lam2),
        KIND_CODE[penalty.kind], grid, rows, chunk, vec,
        _build.stream_ptr(A_t.device))
    _build.check(err, "sweep_tiled_t")
    _build.launches["sweep_tiled_t"] += 1
    return x_out, r_out
