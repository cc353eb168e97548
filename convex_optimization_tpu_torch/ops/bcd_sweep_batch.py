"""K5, K6, K7: the batched-lambda sweep, refresh and witness over the
transposed block-major layout ``A_t`` (n_blocks, B, m).

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_vpu_batch.py``.  L
path points (one lam1 each, L <= MAX_BATCH) share every read of A:

    X (n_blocks, L, B)   iterates, row l of block j is x_j at lam1_l
    R (L, m)             residual rows r_l = A x_l - b

The kernels are ``csrc/sweep_batch.cu`` (K5) and ``csrc/matvec_batch.cu``
(K6, K7); their notes give the designs.  Each wrapper takes its plain
PyTorch version for CPU tensors and launches its kernel, or raises, for
CUDA tensors.

The TPU module's VMEM model (``fits_vmem_vpu_batch``) and its DMA-staged row
mask do not carry over: the H100's limit is K5's shared-memory tile, which
the C side checks (``batch_grid``), and the row mask is a plain operand.

Row mask: with a 0/1 ``row_mask`` (m,) the sweep is that of the row-masked
problem (rm * A, rm * b) on the unmasked A, provided R comes in masked; the
mask multiplies the phase-2 update, so the result equals, bit for bit, the
same sweep on a masked copy of A (both in the plain version and in K5).
"""

from __future__ import annotations

import ctypes

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import _KIND_CODE
from convex_optimization_tpu_torch.ops.matvec import _check, _on_cuda

#: most path points one batched launch carries (K5-K7 keep L accumulators
#: per thread in registers, sized for this)
MAX_BATCH = 16

#: (device index, B, m, L) -> K5 cooperative grid size, 0 when no fit
_grid_cache: dict = {}

_MV_THREADS = 256


def _flat(A_t: torch.Tensor) -> torch.Tensor:
    nb, B, m = A_t.shape
    return A_t.view(nb * B, m)


def rows_of(X: torch.Tensor) -> torch.Tensor:
    """(n_blocks, L, B) -> (L, n): the path points as rows."""
    nb, L, B = X.shape
    return X.transpose(0, 1).reshape(L, nb * B)


def blocks_of(xs: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(L, n) -> contiguous (n_blocks, L, B)."""
    L, n = xs.shape
    return xs.view(L, n_blocks, n // n_blocks).transpose(0, 1).contiguous()


# ------------------------------------------------------------------ K5 ----

def _prox_rows(v: torch.Tensor, tl: torch.Tensor, penalty: Penalty,
               j: int, n: int) -> torch.Tensor:
    """Prox of block j (of n coordinates in all) for L rows at once:
    v (L, B), tl (L, 1) the per-row thresholds t_j * lam1_l."""
    if penalty.kind == "l1":
        return torch.sign(v) * torch.clamp(torch.abs(v) - tl, min=0.0)
    if penalty.kind == "nonneg_l1":
        return torch.clamp(v - tl, min=0.0)
    if penalty.kind == "group_l2":
        L, B = v.shape
        gsize = n // penalty.ngroups
        gpb = B // gsize
        vg = v.view(L, gpb, gsize)
        w = penalty._gweights(v.dtype, v.device)[j * gpb:(j + 1) * gpb]
        gn = torch.linalg.vector_norm(vg, dim=2, keepdim=True)
        scale = torch.clamp(
            1.0 - tl[:, :, None] * w[None, :, None]
            / torch.clamp(gn, min=1e-30), min=0.0)
        return (vg * scale).reshape(L, B)
    raise ValueError(f"unknown penalty kind {penalty.kind!r}")


def batch_sweep_t_plain(A_t: torch.Tensor, X: torch.Tensor, R: torch.Tensor,
                        steps: torch.Tensor, lam1s: torch.Tensor,
                        lam2: float, penalty: Penalty,
                        keep_mask: torch.Tensor | None = None,
                        row_mask: torch.Tensor | None = None,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: a Python loop over the blocks, in order.

    Both phases form the elementwise products and sum them with
    ``torch.sum``, not a BLAS product, whose summation order may depend on
    operand alignment: the masked sweep must equal the sweep on a masked
    copy of A bit for bit."""
    nb, B, m = A_t.shape
    X = X.clone()
    R = R.clone()
    tl_all = lam1s.to(A_t.dtype)[:, None]                      # (L, 1)
    for j in range(nb):
        Aj = A_t[j]                                            # (B, m)
        xj = X[j]                                              # (L, B)
        g = (Aj[None, :, :] * R[:, None, :]).sum(dim=2)        # (L, B)
        t = steps[j]
        v = xj - t * (g + lam2 * xj)
        x_new = _prox_rows(v, t * tl_all, penalty, j, nb * B)
        if keep_mask is not None:
            x_new = torch.where(keep_mask[j * B:(j + 1) * B][None, :],
                                x_new, torch.zeros_like(x_new))
        dx = x_new - xj
        upd = (dx[:, :, None] * Aj[None, :, :]).sum(dim=1)     # (L, m)
        if row_mask is not None:
            upd = row_mask[None, :] * upd
        R += upd
        X[j] = x_new
    return X, R


def batch_grid(device: torch.device, B: int, m: int, L: int) -> int:
    """Cooperative grid size of K5 at (B, m, L) on ``device``; 0 when its
    shared-memory tile does not fit."""
    key = (device.index, B, m, L)
    if key not in _grid_cache:
        lib = _build.load()
        g = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.cot_batch_sweep_grid(B, m, L, ctypes.byref(g)),
                         "cot_batch_sweep_grid")
        _grid_cache[key] = g.value
    return _grid_cache[key]


def eligible_batch(m: int, n: int, B: int, L: int, *,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | None = None) -> bool:
    """Whether the batched kernels take this shape: f32, 1 <= L <=
    MAX_BATCH, B a multiple of 8 dividing n, and on a CUDA device a K5
    tile that fits shared memory (asked of the C side)."""
    ok = (dtype == torch.float32 and 1 <= L <= MAX_BATCH
          and B >= 8 and B % 8 == 0 and n % B == 0)
    if ok and device is not None and device.type == "cuda":
        ok = batch_grid(device, B, m, L) > 0
    return ok


def batch_sweep_t(A_t: torch.Tensor, X: torch.Tensor, R: torch.Tensor,
                  steps: torch.Tensor, lam1s: torch.Tensor, lam2: float,
                  penalty: Penalty, keep_mask: torch.Tensor | None = None,
                  row_mask: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched cyclic sweep; returns new (X, R).

    A_t (n_blocks, B, m), X (n_blocks, L, B), R (L, m), steps (n_blocks,),
    lam1s (L,), row_mask None or (m,) 0/1, all f32; keep_mask None or (n,)
    bool.  ``penalty`` gives the kind (and group weights); its lam1 is
    ignored in favour of lam1s.  CPU tensors take the plain version; CUDA
    tensors launch K5 or raise."""
    if not _on_cuda(A_t):
        return batch_sweep_t_plain(A_t, X, R, steps, lam1s, lam2, penalty,
                                   keep_mask, row_mask)
    if penalty.kind not in _KIND_CODE:
        raise NotImplementedError(
            f"K5 on CUDA supports l1 and nonneg_l1, not {penalty.kind!r} "
            "(group_l2: ROADMAP queue 1, item 8)")
    nb, B, m = A_t.shape
    L = X.shape[1]
    if not 1 <= L <= MAX_BATCH:
        raise ValueError(f"L={L} outside 1..{MAX_BATCH}")
    dev = A_t.device
    for name, t, shape in (("A_t", A_t, A_t.shape), ("X", X, (nb, L, B)),
                           ("R", R, (L, m)), ("steps", steps, (nb,)),
                           ("lam1s", lam1s, (L,))):
        _check(name, t, shape, dev)
    if row_mask is not None:
        _check("row_mask", row_mask, (m,), dev)
    if keep_mask is not None:
        if keep_mask.device != dev or keep_mask.dtype != torch.bool \
                or tuple(keep_mask.shape) != (nb * B,) \
                or not keep_mask.is_contiguous():
            raise ValueError(f"keep_mask: expected contiguous bool "
                             f"({nb * B},) on {dev}")
    grid = batch_grid(dev, B, m, L)
    if grid == 0:
        raise ValueError(f"K5 tile of B={B}, m={m}, L={L} does not fit in "
                         "shared memory")
    X_out = torch.empty_like(X)
    R_out = torch.empty_like(R)
    partials = torch.empty(((grid + 1) * L * B,), dtype=torch.float32,
                           device=dev)
    err = _build.load().cot_batch_sweep_t(
        A_t.data_ptr(), X.data_ptr(), R.data_ptr(), steps.data_ptr(),
        lam1s.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        X_out.data_ptr(), R_out.data_ptr(), partials.data_ptr(),
        nb, B, m, L, float(lam2), _KIND_CODE[penalty.kind], grid,
        _build.stream_ptr(dev))
    _build.check(err, "batch_sweep_t")
    _build.launches["batch_sweep_t"] += 1
    return X_out, R_out


# ------------------------------------------------------------------ K6 ----

def ax_minus_b_batch_t_plain(A_t: torch.Tensor, X: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    return rows_of(X) @ _flat(A_t) - b[None, :]


def ax_minus_b_batch_t(A_t: torch.Tensor, X: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """R = A X - b for L rows in one pass over A_t: X (n_blocks, L, B),
    b (m,) -> R (L, m)."""
    if not _on_cuda(A_t):
        return ax_minus_b_batch_t_plain(A_t, X, b)
    nb, B, m = A_t.shape
    L = X.shape[1]
    if not 1 <= L <= MAX_BATCH:
        raise ValueError(f"L={L} outside 1..{MAX_BATCH}")
    for name, t, shape in (("A_t", A_t, A_t.shape), ("X", X, (nb, L, B)),
                           ("b", b, (m,))):
        _check(name, t, shape, A_t.device)
    n = nb * B
    sms = torch.cuda.get_device_properties(A_t.device).multi_processor_count
    tiles = -(-m // _MV_THREADS)
    slices = max(1, min(n, -(-8 * sms // tiles)))
    R = torch.empty((L, m), dtype=torch.float32, device=A_t.device)
    partials = torch.empty((slices, L, m), dtype=torch.float32,
                           device=A_t.device)
    err = _build.load().cot_ax_minus_b_batch_t(
        A_t.data_ptr(), X.data_ptr(), b.data_ptr(), R.data_ptr(),
        partials.data_ptr(), nb, B, m, L, slices,
        _build.stream_ptr(A_t.device))
    _build.check(err, "ax_minus_b_batch_t")
    _build.launches["ax_minus_b_batch_t"] += 1
    return R


# ------------------------------------------------------------------ K7 ----

def neg_at_r_batch_t_plain(A_t: torch.Tensor, R: torch.Tensor,
                           X: torch.Tensor, lam2: float) -> torch.Tensor:
    nb = A_t.shape[0]
    return blocks_of(-(R @ _flat(A_t).T), nb) - lam2 * X


def neg_at_r_batch_t(A_t: torch.Tensor, R: torch.Tensor, X: torch.Tensor,
                     lam2: float) -> torch.Tensor:
    """Z = -A^T R - lam2 X for L rows in one pass over A_t: R (L, m),
    X (n_blocks, L, B) -> Z (n_blocks, L, B)."""
    if not _on_cuda(A_t):
        return neg_at_r_batch_t_plain(A_t, R, X, lam2)
    nb, B, m = A_t.shape
    L = X.shape[1]
    if not 1 <= L <= MAX_BATCH:
        raise ValueError(f"L={L} outside 1..{MAX_BATCH}")
    for name, t, shape in (("A_t", A_t, A_t.shape), ("R", R, (L, m)),
                           ("X", X, (nb, L, B))):
        _check(name, t, shape, A_t.device)
    Z = torch.empty_like(X)
    err = _build.load().cot_neg_at_r_batch_t(
        A_t.data_ptr(), R.data_ptr(), X.data_ptr(), Z.data_ptr(), nb, B, m,
        L, float(lam2), _build.stream_ptr(A_t.device))
    _build.check(err, "neg_at_r_batch_t")
    _build.launches["neg_at_r_batch_t"] += 1
    return Z
