"""K2, K3, K4: one-pass matvecs and the per-block power iteration over the
transposed block-major layout ``A_t`` (n_blocks, B, m).

Counterpart of ``convex_optimization_tpu/ops/matvec_pallas.py``.  The
kernels are in ``csrc/matvec.cu`` (its notes give the designs); each
wrapper below takes its plain PyTorch version for CPU tensors and launches
its kernel, or raises, for CUDA tensors.

``k3_depth`` and ``witness_gamma`` carry K3's worst-case summation depth
to the f64 polish, whose certificate margin rests on it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convex_optimization_tpu_torch.ops import _build

_AX_THREADS = 256


def _flat(A_t: torch.Tensor) -> torch.Tensor:
    nb, B, m = A_t.shape
    return A_t.view(nb * B, m)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, A_t on {device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(A_t: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA; else raise."""
    if A_t.device.type == "cpu":
        return False
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    return True


# ------------------------------------------------------------------ K2 ----

def ax_minus_b_t_plain(A_t: torch.Tensor, x: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    return torch.mv(_flat(A_t).T, x) - b


def ax_minus_b_t(A_t: torch.Tensor, x: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """r = A x - b in one pass over A_t; x (n,), b and r (m,)."""
    if not _on_cuda(A_t):
        return ax_minus_b_t_plain(A_t, x, b)
    nb, B, m = A_t.shape
    n = nb * B
    for name, t, shape in (("A_t", A_t, A_t.shape), ("x", x, (n,)),
                           ("b", b, (m,))):
        _check(name, t, shape, A_t.device)
    sms = torch.cuda.get_device_properties(A_t.device).multi_processor_count
    tiles = -(-m // _AX_THREADS)
    slices = max(1, min(n, -(-8 * sms // tiles)))
    r = torch.empty((m,), dtype=torch.float32, device=A_t.device)
    partials = torch.empty((slices, m), dtype=torch.float32,
                           device=A_t.device)
    err = _build.load().cot_ax_minus_b_t(
        A_t.data_ptr(), x.data_ptr(), b.data_ptr(), r.data_ptr(),
        partials.data_ptr(), n, m, slices, _build.stream_ptr(A_t.device))
    _build.check(err, "ax_minus_b_t")
    _build.launches["ax_minus_b_t"] += 1
    return r


# ------------------------------------------------------------------ K3 ----

def k3_depth(m: int) -> int:
    """Worst-case number of roundings any product passes through in K3's
    dot of length m (csrc/matvec.cu, K3 note): ceil(m / 2048) + 11."""
    return -(-m // 2048) + 11


def witness_gamma(m: int) -> float:
    """Relative rounding bound gamma of K3's f32 witness, so that
    |z32_j - (A^T r)_j| <= gamma ||A_j|| ||r||: the JAX package's margin
    (ceil(log2 m) + 4) eps when K3's depth fits it, else the depth's own
    (ceil(D / 2) + 4) eps; eps = 2u covers two roundings per level, and
    the + 4 eps covers rounding r to f32 and the column norms."""
    eps = float(np.finfo(np.float32).eps)
    log_terms = math.ceil(math.log2(max(m, 2))) + 4
    return max(log_terms, -(-k3_depth(m) // 2) + 4) * eps


def neg_at_r_t_plain(A_t: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
                     lam2: float, chunk: int = 8192) -> torch.Tensor:
    """Plain version of K3, summed in float64 and rounded to A_t's dtype
    (float32 on the kernel's path): its error, half an ulp of z, lies
    inside K3's bound, so the polish certificate stays sound on the CPU
    path too (a BLAS sgemv's serial chains would not).  Chunked so the f64
    copy stays small."""
    A2 = _flat(A_t)
    r64 = r.to(torch.float64)
    z = torch.empty((A2.shape[0],), dtype=torch.float64, device=A2.device)
    for c0 in range(0, A2.shape[0], chunk):
        z[c0:c0 + chunk] = torch.mv(A2[c0:c0 + chunk].to(torch.float64), r64)
    return (-z - lam2 * x.to(torch.float64)).to(A_t.dtype)


def neg_at_r_t(A_t: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
               lam2: float) -> torch.Tensor:
    """Dual witness z = -(A^T r) - lam2 x in one pass; r (m,), x and z (n,)."""
    if not _on_cuda(A_t):
        return neg_at_r_t_plain(A_t, r, x, lam2)
    nb, B, m = A_t.shape
    n = nb * B
    for name, t, shape in (("A_t", A_t, A_t.shape), ("r", r, (m,)),
                           ("x", x, (n,))):
        _check(name, t, shape, A_t.device)
    z = torch.empty((n,), dtype=torch.float32, device=A_t.device)
    err = _build.load().cot_neg_at_r_t(
        A_t.data_ptr(), r.data_ptr(), x.data_ptr(), z.data_ptr(), n, m,
        float(lam2), _build.stream_ptr(A_t.device))
    _build.check(err, "neg_at_r_t")
    _build.launches["neg_at_r_t"] += 1
    return z


# ------------------------------------------------------------------ K4 ----

def _power_start(B: int, dtype, device) -> torch.Tensor:
    """The TPU kernel's start vector 1 + 0.01 b / B, evaluated in f32 in
    the same order."""
    b = torch.arange(B, dtype=torch.float32, device=device)
    return (1.0 + (0.01 * b) / B).to(dtype)


def block_power_t_plain(A_t: torch.Tensor, *, iters: int = 48,
                        safety: float = 1.02) -> torch.Tensor:
    """Plain version of K4: the same iteration for all blocks at once
    (batched matvecs; two passes over A per iteration)."""
    nb, B, m = A_t.shape
    v = _power_start(B, A_t.dtype, A_t.device).expand(nb, B).unsqueeze(2)
    for _ in range(iters):
        u = torch.bmm(A_t.transpose(1, 2), v)              # (nb, m, 1)
        w = torch.bmm(A_t, u)                              # (nb, B, 1)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            min=1e-30)
    u = torch.bmm(A_t.transpose(1, 2), v)
    num = torch.sum(u * u, dim=(1, 2))
    den = torch.clamp(torch.sum(v * v, dim=(1, 2)), min=1e-30)
    return safety * num / den


def block_power_t(A_t: torch.Tensor, *, iters: int = 48,
                  safety: float = 1.02) -> torch.Tensor:
    """Per-block ||A_j||_2^2 estimates (n_blocks,): ``iters`` power
    iterations from the tilted ones vector, then the Rayleigh quotient
    times ``safety``."""
    if not _on_cuda(A_t):
        return block_power_t_plain(A_t, iters=iters, safety=safety)
    _check("A_t", A_t, A_t.shape, A_t.device)
    nb, B, m = A_t.shape
    out = torch.empty((nb,), dtype=torch.float32, device=A_t.device)
    err = _build.load().cot_block_power_t(
        A_t.data_ptr(), out.data_ptr(), nb, B, m, int(iters), float(safety),
        _build.stream_ptr(A_t.device))
    _build.check(err, "block_power_t")
    _build.launches["block_power_t"] += 1
    return out


def spectral_norm_sq_t(A_t: torch.Tensor, *, iters: int = 48,
                       safety: float = 1.02) -> torch.Tensor:
    """||A||_2^2 by power iteration composed of K2 and K3 (not a kernel of
    its own), from the JAX package's deterministic start sin(1..n)."""
    nb, B, m = A_t.shape
    n = nb * B
    zeros_m = torch.zeros((m,), dtype=A_t.dtype, device=A_t.device)
    zeros_n = torch.zeros((n,), dtype=A_t.dtype, device=A_t.device)
    v = torch.sin(torch.arange(1, n + 1, dtype=A_t.dtype, device=A_t.device))
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        u = ax_minus_b_t(A_t, v, zeros_m)
        w = -neg_at_r_t(A_t, u, zeros_n, 0.0)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    u = ax_minus_b_t(A_t, v, zeros_m)
    return safety * torch.dot(u, u) / torch.clamp(torch.dot(v, v), min=1e-30)
