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

import ctypes
import dataclasses
import math

import numpy as np
import torch

from convex_optimization_tpu_torch.ops import _build

#: K2: columns per CTA (each of its 8 warps reads 4 KB of a row at once)
K2_TILE_COLS = 1024
#: K3: warps per CTA, columns per lane group (8 float4 steps of a warp),
#: and the widest chunk of r a CTA stages (112 KB: two CTAs per SM)
_K3_WARPS = 16
K3_GROUP_COLS = 1024
K3_MAX_COLS = 28 * K3_GROUP_COLS


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


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# ------------------------------------------------------------ the plan ----

def k3_chunking(m: int) -> tuple[int, int, int]:
    """K3's split of the m columns (csrc/matvec.cu, K3 note): chunk width
    W (a multiple of K3_GROUP_COLS, at most K3_MAX_COLS), chunks C =
    ceil(m / W), none empty, and K, the lane groups chained into one
    supergroup sum: ceil(sqrt(W / K3_GROUP_COLS))."""
    C = -(-m // K3_MAX_COLS)
    W = -(-(-(-m // C)) // K3_GROUP_COLS) * K3_GROUP_COLS
    C = -(-m // W)
    g = W // K3_GROUP_COLS
    return W, C, math.isqrt(g - 1) + 1


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    """K2's and K3's launch at one (n, m) on one card."""
    vec: bool             # m % 4 == 0: the float4 instances (A_t permitting)
    k2_tiles: int         # K2 column tiles (grid.x)
    k2_slices: int        # K2 row slices (grid.y), partial rows (S, m)
    k3_width: int         # W: columns of r per K3 chunk
    k3_chunks: int        # C: K3 chunks (grid.y), partials (C, n) if C > 1
    k3_ctas: int          # K3 CTAs per chunk (grid.x)
    k3_chain: int         # K: lane groups per supergroup sum


def matvec_tiling(n: int, m: int, sms: int, k2_per_sm: int,
                  k3_per_sm: int) -> MatvecPlan:
    """The pure part of ``matvec_plan``: K2's and K3's tiling at (n, m) on
    a card of ``sms`` SMs where ``k2_per_sm`` and ``k3_per_sm`` CTAs of
    each fit at once.  Each grid is one wave of those slots, never more
    (unless K2's column tiles alone exceed it, or K3's chunks), and no
    slice, chunk or CTA is empty."""
    tiles = -(-m // K2_TILE_COLS)
    S = max(1, min(n, k2_per_sm * sms // tiles))
    S = -(-n // -(-n // S))                         # no empty slice
    W, C, K = k3_chunking(m)
    G = max(1, min(k3_per_sm * sms // C, -(-n // _K3_WARPS)))
    return MatvecPlan(vec=m % 4 == 0, k2_tiles=tiles, k2_slices=S,
                      k3_width=W, k3_chunks=C, k3_ctas=G, k3_chain=K)


#: (device index, n, m) -> MatvecPlan
_plan_cache: dict = {}


def matvec_plan(device: torch.device, n: int, m: int) -> MatvecPlan:
    """K2's and K3's launch plan at (n, m) on ``device``: the SM count
    from torch, each kernel's co-resident CTAs per SM from the C side
    (``cot_matvec_occupancy``), the tiling from ``matvec_tiling``."""
    key = (device.index, n, m)
    if key not in _plan_cache:
        occ = (ctypes.c_int * 2)()
        W = k3_chunking(m)[0]
        with torch.cuda.device(device):
            _build.check(_build.load().cot_matvec_occupancy(4 * W, occ),
                         "cot_matvec_occupancy")
        if min(occ) < 1:
            raise RuntimeError(f"K2/K3 fit no SM: occupancy {list(occ)}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _plan_cache[key] = matvec_tiling(n, m, sms, occ[0], occ[1])
    return _plan_cache[key]


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
    plan = matvec_plan(A_t.device, n, m)
    r = torch.empty((m,), dtype=torch.float32, device=A_t.device)
    partials = torch.empty((plan.k2_slices, m), dtype=torch.float32,
                           device=A_t.device)
    err = _build.load().cot_ax_minus_b_t(
        A_t.data_ptr(), x.data_ptr(), b.data_ptr(), r.data_ptr(),
        partials.data_ptr(), n, m, plan.k2_slices,
        int(plan.vec and _aligned(A_t)), _build.stream_ptr(A_t.device))
    _build.check(err, "ax_minus_b_t")
    _build.launches["ax_minus_b_t"] += 1
    return r


# ------------------------------------------------------------------ K3 ----

def k3_depth(m: int) -> int:
    """Worst-case number of roundings any product passes through in K3's
    dot of length m (csrc/matvec.cu, K3 note): 1 + 2 + 3 + (K - 1) +
    (ceil(g / K) - 1) + 5 + (C - 1), with (W, C, K) = k3_chunking(m) and
    g = W / 1024 lane groups per chunk."""
    W, C, K = k3_chunking(m)
    g = W // K3_GROUP_COLS
    return 6 + (K - 1) + (-(-g // K) - 1) + 5 + (C - 1)


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
    plan = matvec_plan(A_t.device, n, m)
    z = torch.empty((n,), dtype=torch.float32, device=A_t.device)
    partials = (torch.empty((plan.k3_chunks, n), dtype=torch.float32,
                            device=A_t.device)
                if plan.k3_chunks > 1 else None)
    err = _build.load().cot_neg_at_r_t(
        A_t.data_ptr(), r.data_ptr(), x.data_ptr(), z.data_ptr(),
        None if partials is None else partials.data_ptr(), n, m,
        plan.k3_width, plan.k3_chunks, plan.k3_ctas, plan.k3_chain,
        int(plan.vec and _aligned(A_t, r)), float(lam2),
        _build.stream_ptr(A_t.device))
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


#: K4's ring stage's columns (csrc/matvec.cu, K4 note), the columns a
#: slice keeps at least when the m columns are split, and the scratch a
#: call may hold at once
K4_STAGE_COLS = 32
K4_MIN_SLICE = 2048
K4_SCRATCH_BYTES = 2 << 30
#: shared memory a CTA may use (route "smem" holds G_j, v and w there)
K4_MAX_SMEM_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class PowerPlan:
    """K4's launch at (n_blocks, B, m) on one card."""
    tile: int             # Gram tile edge: 80, 200 or 128
    slices: int           # S: slices of the m columns (grid.y)
    per_slice: int        # columns per slice, a multiple of 32
    route: str            # "smem": G_j in shared memory for every step;
                          # "global": G in global memory, a launch a step
    chunk: int            # blocks per call, so that the scratch stays small


def power_tiling(nb: int, B: int, m: int, sms: int) -> PowerPlan:
    """K4's plan at (nb, B, m) on a card of ``sms`` SMs.  The tile: 80
    for B <= 80 and 200 for B <= 200 (one tile per block), else the upper
    triangle of 128-tiles.  The m columns stay whole unless the tiles of
    all blocks number fewer than two per SM; then they are cut into
    slices of at least K4_MIN_SLICE columns, up to two CTAs per SM.  Route
    "smem" where G_j, v and w fit K4_MAX_SMEM_BYTES, else "global".
    Blocks go in chunks whose scratch (G, the slices' partial Grams, route
    "global"'s two w) stays within K4_SCRATCH_BYTES."""
    tile = 80 if B <= 80 else 200 if B <= 200 else 128
    nt = -(-B // tile)
    ctas = nb * nt * (nt + 1) // 2
    S = 1
    if ctas < 2 * sms:
        S = max(1, min(-(-2 * sms // ctas), m // K4_MIN_SLICE))
    per = -(-(-(-m // S)) // K4_STAGE_COLS) * K4_STAGE_COLS
    S = -(-m // per)
    route = "smem" if 4 * (B * B + 2 * B) <= K4_MAX_SMEM_BYTES else "global"
    per_block = 4 * B * B * (1 + (S if S > 1 else 0)) \
        + (8 * B if route == "global" else 0)
    chunk = max(1, min(nb, K4_SCRATCH_BYTES // per_block, 65535))
    return PowerPlan(tile, S, per, route, chunk)


def block_power_t(A_t: torch.Tensor, *, iters: int = 48,
                  safety: float = 1.02) -> torch.Tensor:
    """Per-block ||A_j||_2^2 estimates (n_blocks,): ``iters`` power
    iterations from the tilted ones vector, then the Rayleigh quotient
    times ``safety``.  On the card, K4 forms each block's Gram matrix and
    iterates on it (``power_tiling``)."""
    if not _on_cuda(A_t):
        return block_power_t_plain(A_t, iters=iters, safety=safety)
    _check("A_t", A_t, A_t.shape, A_t.device)
    nb, B, m = A_t.shape
    sms = torch.cuda.get_device_properties(A_t.device).multi_processor_count
    plan = power_tiling(nb, B, m, sms)
    dev = A_t.device
    out = torch.empty((nb,), dtype=torch.float32, device=dev)
    c = plan.chunk
    G = torch.empty((c, B, B), dtype=torch.float32, device=dev)
    partials = (torch.empty((plan.slices, c, B, B), dtype=torch.float32,
                            device=dev) if plan.slices > 1 else None)
    w = (torch.empty((2, c, B), dtype=torch.float32, device=dev)
         if plan.route == "global" else None)
    vec = int(m % 4 == 0 and _aligned(A_t))
    lib = _build.load()
    for j0 in range(0, nb, c):
        err = lib.cot_block_power_t(
            A_t[j0].data_ptr(), out[j0:].data_ptr(), G.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if w is None else w.data_ptr(), min(c, nb - j0), B, m,
            plan.tile, plan.slices, plan.per_slice,
            int(plan.route == "global"), vec, int(iters), float(safety),
            _build.stream_ptr(dev))
        _build.check(err, "block_power_t")
    _build.launches["block_power_t"] += 1
    return out


def power_iteration(av, atu, v0: torch.Tensor, vdot=torch.dot, *,
                    iters: int = 48, safety: float = 1.02) -> torch.Tensor:
    """||A||_2^2 by power iteration on A^T A from ``v0``: ``av(v)`` = A v,
    ``atu(u)`` = A^T u, ``vdot`` the inner product of two n-vectors (the
    column-sharded solver passes products and a dot that reduce over the
    ranks, and its slice of the start)."""
    v = v0 / torch.sqrt(vdot(v0, v0))
    for _ in range(iters):
        w = atu(av(v))
        v = w / torch.clamp(torch.sqrt(vdot(w, w)), min=1e-30)
    u = av(v)
    return safety * torch.dot(u, u) / torch.clamp(vdot(v, v), min=1e-30)


def sin_start(n: int, dtype, device, lo: int = 0) -> torch.Tensor:
    """Entries lo .. lo + n of the JAX package's deterministic power
    iteration start sin(1, 2, ...)."""
    return torch.sin(torch.arange(lo + 1, lo + n + 1, dtype=dtype,
                                  device=device))


def spectral_norm_sq_t(A_t: torch.Tensor, *, iters: int = 48,
                       safety: float = 1.02) -> torch.Tensor:
    """||A||_2^2 by power iteration composed of K2 and K3 (not a kernel of
    its own): the FISTA step size."""
    nb, B, m = A_t.shape
    zeros_m = torch.zeros((m,), dtype=A_t.dtype, device=A_t.device)
    zeros_n = torch.zeros((nb * B,), dtype=A_t.dtype, device=A_t.device)
    return power_iteration(lambda v: ax_minus_b_t(A_t, v, zeros_m),
                           lambda u: -neg_at_r_t(A_t, u, zeros_n, 0.0),
                           sin_start(nb * B, A_t.dtype, A_t.device),
                           iters=iters, safety=safety)


def spectral_norm_sq(A_t: torch.Tensor, *, iters: int = 48,
                     safety: float = 1.02) -> torch.Tensor:
    """Plain form of ``spectral_norm_sq_t``: the same iteration with
    PyTorch matvecs on any device."""
    A_rows = _flat(A_t)
    return power_iteration(lambda v: torch.mv(A_rows.T, v),
                           lambda u: torch.mv(A_rows, u),
                           sin_start(A_rows.shape[0], A_t.dtype, A_t.device),
                           iters=iters, safety=safety)
