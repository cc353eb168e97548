"""K1: the fused Gauss-Seidel sweep over the transposed block-major layout.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_vpu.py``.  The
kernel is ``csrc/sweep.cu`` (its note gives the design); ``sweep_t`` is its
wrapper and ``sweep_t_plain`` its plain PyTorch version, which runs for
CPU tensors and is the kernel's oracle on the card.

The TPU module's VMEM and 13 GiB HBM gates do not carry over: the H100's
limit is the kernel's shared-memory tile (B x ceil(m / SMs) floats), which
the C side checks.
"""

from __future__ import annotations

import math

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import sweep_blocks

_KIND_CODE = {"l1": 0, "nonneg_l1": 1}

#: (device index, B, m) -> cooperative grid size
_grid_cache: dict = {}


def pick_block_size_t(n: int, target: int = 128,
                      multiple_of: int = 1) -> tuple[int, int]:
    """(B, pad): the largest multiple of lcm(8, multiple_of) that divides n
    and is <= target, with pad 0; when none divides n, the largest such
    multiple <= target and the zero columns ``pad`` that make it divide
    n + pad.  The same choice as the JAX package's
    ``pick_padded_block_size_vpu`` wherever its VMEM gate holds (B = 80 at
    n = 100000)."""
    step = 8 * multiple_of // math.gcd(8, multiple_of)
    best = best_nopad = None
    b = step
    while b <= max(target, step):
        n_pad = -(-n // b) * b
        best = (b, n_pad - n)
        if n_pad == n:
            best_nopad = (b, 0)
        b += step
    return best_nopad or best


def to_tblock_major(A: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(m, n) -> contiguous (n_blocks, B, m) (one transposing copy)."""
    m, n = A.shape
    return A.T.contiguous().view(n_blocks, n // n_blocks, m)


def sweep_t_plain(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                  steps: torch.Tensor, keep_mask: torch.Tensor | None,
                  penalty: Penalty, lam2: float,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: a Python loop over the blocks, in order."""
    nb, B, m = A_t.shape
    return sweep_blocks(A_t.view(nb * B, m), x, r, steps, range(nb),
                        penalty, lam2, keep_mask)


def _check_operands(A_t, x, r, steps, keep_mask) -> None:
    nb, B, m = A_t.shape
    want = [("A_t", A_t, (nb, B, m), torch.float32),
            ("x", x, (nb * B,), torch.float32),
            ("r", r, (m,), torch.float32),
            ("steps", steps, (nb,), torch.float32)]
    if keep_mask is not None:
        want.append(("keep_mask", keep_mask, (nb * B,), torch.bool))
    for name, t, shape, dtype in want:
        if t.device != A_t.device:
            raise ValueError(f"{name} is on {t.device}, A_t on {A_t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sweep_grid(device: torch.device, B: int, m: int) -> int:
    """Cooperative grid size of K1 at (B, m) on ``device``."""
    key = (device.index, B, m)
    if key not in _grid_cache:
        import ctypes

        lib = _build.load()
        g = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.cot_sweep_grid(B, m, ctypes.byref(g)),
                         "cot_sweep_grid")
        if g.value == 0:
            raise ValueError(f"sweep tile of B={B} x m={m} does not fit "
                             "in shared memory")
        _grid_cache[key] = g.value
    return _grid_cache[key]


def sweep_t(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
            steps: torch.Tensor, keep_mask: torch.Tensor | None,
            penalty: Penalty, lam2: float,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cyclic sweep; returns new (x, r).

    A_t (n_blocks, B, m) f32; x (n,), r (m,) = A x - b, steps (n_blocks,)
    the per-block steps t_j = step_scale / (L_j + lam2), all f32;
    keep_mask None or (n,) bool.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if A_t.device.type == "cpu":
        return sweep_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    if penalty.kind not in _KIND_CODE:
        raise NotImplementedError(
            f"K1 on CUDA supports l1 and nonneg_l1, not {penalty.kind!r} "
            "(group_l2: ROADMAP queue 1, item 8)")
    _check_operands(A_t, x, r, steps, keep_mask)
    nb, B, m = A_t.shape
    grid = sweep_grid(A_t.device, B, m)
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    partials = torch.empty((2 * grid * B,), dtype=torch.float32,
                           device=A_t.device)
    lib = _build.load()
    err = lib.cot_sweep_t(
        A_t.data_ptr(), x.data_ptr(), r.data_ptr(), steps.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        x_out.data_ptr(), r_out.data_ptr(), partials.data_ptr(),
        nb, B, m, float(penalty.lam1), float(lam2),
        _KIND_CODE[penalty.kind], grid, _build.stream_ptr(A_t.device))
    _build.check(err, "sweep_t")
    _build.launches["sweep_t"] += 1
    return x_out, r_out


def block_steps(block_L: torch.Tensor, lam2: float,
                step_scale: float = 1.0) -> torch.Tensor:
    """t_j = step_scale / (L_j + lam2), f32 as the kernel reads it."""
    return (step_scale / (block_L + lam2)).to(torch.float32).contiguous()

