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
mask do not carry over: the H100's limit is K5's shared memory, which its
launch plan (``batch_sweep_tiling``, checked on the card by ``batch_plan``)
fits, and the row mask is a plain operand.

Row mask: with a 0/1 ``row_mask`` (m,) the sweep is that of the row-masked
problem (rm * A, rm * b) on the unmasked A, provided R comes in masked; the
mask multiplies the phase-2 update, so the result equals, bit for bit, the
same sweep on a masked copy of A (both in the plain version and in K5).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    KIND_CODE,
    group_operands,
    up4,
)
from convex_optimization_tpu_torch.ops.matvec import (
    _aligned,
    _check,
    _on_cuda,
)

#: most path points one batched launch carries (K5, K6 and K7 are
#: templated on L rounded up to 4, up to it)
MAX_BATCH = 16

#: K5's threads per CTA (csrc/sweep_batch.cu kThreads), the shared memory
#: one CTA may take on the H100, the most segments a phase is split into,
#: and the threads phase 1's segments aim at (each of its units keeps 2 LP
#: independent sums, so fewer threads than phase 2's keep the SM busy)
K5_THREADS = 384
K5_MAX_SMEM_BYTES = 227 * 1024
K5_MAX_SEGMENTS = 8
K5_PHASE1_THREADS = 256
#: the shortest tile row (floats) that K5 loads with the bulk-copy engine:
#: one copy per row of a CTA's tile, which pays off on long rows (608 bytes
#: at config 4) and loses to 16-byte cp.async on short ones (160 bytes at
#: config 2; PERF.md)
K5_BULK_MIN_ROWS = 128
#: (device index, B, m, L, gsize) -> K5's BatchSweepPlan, None when no fit
#: (gsize 0 outside group_l2: the group prox needs more shared memory)
_k5_plan_cache: dict = {}
#: (device index, n, m, L) -> K6/K7 launch plan (matvec_batch_plan)
_plan_cache: dict = {}


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


@dataclasses.dataclass(frozen=True)
class BatchSweepPlan:
    """K5's launch at one (B, m, L, gsize): ``grid`` CTAs of ``rows`` rows
    each; tile rows of stride ``ld`` floats in shared memory; ``vec``: the
    float4 instance (m % 4 == 0, rows % 4 == 0, ld % 8 == 4), whose copies
    are 16 bytes when A_t is 16-byte aligned; ``prefetch``: the b-rows of
    tile j + 1 in flight across block j's barriers (B: a double buffer);
    ``s1``, ``s2``: the segments phase 1 and phase 2 are split into;
    ``rw``: the warps that split each reduced pair's G partials (all 16, or
    1 with no shared scratch); ``bulk``: load the tile with the bulk-copy
    engine (when A_t is aligned) rather than 16-byte cp.async."""
    B: int
    L: int
    gsize: int
    grid: int
    rows: int
    ld: int
    vec: bool
    prefetch: int
    s1: int
    s2: int
    rw: int
    bulk: bool = False

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the layout (csrc/sweep_batch.cu ``layout``)."""
        B, L, rows, vec = self.B, self.L, self.rows, self.vec
        LP = -(-L // 4) * 4
        red = max((self.s1 - 1) * 2 * LP * -(-B // 2),
                  (self.s2 - 1) * LP * rows)
        floats = ((B + self.prefetch) * self.ld + up4(L * rows, vec)
                  + up4(rows, vec) + up4(B * (LP if vec else L), vec)
                  + up4(red, vec))
        if self.rw > 1:
            floats += 32 * self.rw
        if self.gsize:
            floats += L * B + L * (B // self.gsize)
        if vec:                           # two mbarriers for the bulk copies
            floats = up4(floats, vec) + 4
        return 4 * floats


def batch_sweep_tiling(B: int, m: int, L: int, gsize: int, sms: int,
                       smem_limit: int = K5_MAX_SMEM_BYTES
                       ) -> BatchSweepPlan | None:
    """The pure part of ``batch_plan``: K5's plan on a card of ``sms`` SMs
    with ``smem_limit`` bytes of shared memory per CTA, or None when even
    the plainest layout does not fit.

    One CTA per SM (at most m), rows = ceil(m / grid); the float4 instance
    (when m % 4 == 0) rounds rows up to 4 and pads ld to 4 mod 8, else ld
    is odd (both keep phase 1's tile reads conflict-free).  Phase 1 (units
    of two tile rows) splits into s1 segments, about K5_PHASE1_THREADS
    threads in all; phase 2 (units of an l-quad and a row unit) into s2, at
    most K5_THREADS threads; both at most K5_MAX_SEGMENTS, or 1 where their
    scratch does not fit; the reduction's 16 warps share a (16, 32) scratch.
    The spare shared memory then holds ``prefetch`` b-rows of the next
    tile, up to B.  The last resort (scalar, unsplit, one reducing warp, no
    prefetch) is the layout of the first K5 design, so every shape that
    design took still fits."""
    G0 = min(sms, m)
    LP = -(-L // 4) * 4
    for vec in ((True, False) if m % 4 == 0 else (False,)):
        rows = -(-m // G0)
        if vec:
            rows = -(-rows // 4) * 4
            ld = rows if rows % 8 == 4 else rows + 4
        else:
            ld = rows | 1
        grid = -(-m // rows)
        units2 = LP // 4 * (rows // 4 if vec else rows)
        s1 = max(1, min(K5_MAX_SEGMENTS, K5_PHASE1_THREADS // -(-B // 2)))
        s2 = max(1, min(K5_MAX_SEGMENTS, K5_THREADS // units2, B))
        for seg in ((s1, s2, K5_THREADS // 32), (1, 1, 1)):
            plan = BatchSweepPlan(B, L, gsize, grid, rows, ld, vec, 0, *seg)
            spare = smem_limit - plan.smem_bytes
            if spare >= 0:
                return dataclasses.replace(
                    plan, prefetch=min(B, spare // (4 * ld)),
                    bulk=vec and rows >= K5_BULK_MIN_ROWS)
    return None


def batch_plan(device: torch.device, B: int, m: int, L: int,
               gsize: int = 0) -> BatchSweepPlan | None:
    """K5's plan at (B, m, L, gsize) on ``device`` (None when no fit): the
    SM count from torch, the tiling from ``batch_sweep_tiling``, checked on
    the C side (``cot_batch_sweep_check``: the same shared-memory bytes,
    and one CTA per SM co-resident for the cooperative launch)."""
    key = (device.index, B, m, L, gsize)
    if key not in _k5_plan_cache:
        props = torch.cuda.get_device_properties(device)
        limit = min(K5_MAX_SMEM_BYTES,
                    getattr(props, "shared_memory_per_block_optin",
                            K5_MAX_SMEM_BYTES))
        plan = batch_sweep_tiling(B, m, L, gsize,
                                  props.multi_processor_count, limit)
        if plan is not None:
            out = (ctypes.c_int * 2)()
            with torch.cuda.device(device):
                _build.check(_build.load().cot_batch_sweep_check(
                    B, L, gsize, plan.rows, plan.ld, plan.prefetch, plan.s1,
                    plan.s2, plan.rw, int(plan.vec), out),
                    "cot_batch_sweep_check")
            if out[0] != plan.smem_bytes:
                raise RuntimeError(f"K5 layout: C side {out[0]} bytes, "
                                   f"plan {plan.smem_bytes}")
            if out[1] < 1:
                raise RuntimeError(f"K5 plan {plan} fits no SM")
        _k5_plan_cache[key] = plan
    return _k5_plan_cache[key]


def eligible_batch(m: int, n: int, B: int, L: int, *,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | None = None,
                   gsize: int = 0) -> bool:
    """Whether the batched kernels take this shape: f32, 1 <= L <=
    MAX_BATCH, B a multiple of 8 dividing n (and of ``gsize``, the group
    width of a group_l2 problem, 0 otherwise), and on a CUDA device a K5
    plan that fits shared memory (``batch_plan``)."""
    ok = (dtype == torch.float32 and 1 <= L <= MAX_BATCH
          and B >= 8 and B % 8 == 0 and n % B == 0
          and (gsize == 0 or B % gsize == 0))
    if ok and device is not None and device.type == "cuda":
        ok = batch_plan(device, B, m, L, gsize) is not None
    return ok


def batch_sweep_t(A_t: torch.Tensor, X: torch.Tensor, R: torch.Tensor,
                  steps: torch.Tensor, lam1s: torch.Tensor, lam2: float,
                  penalty: Penalty, keep_mask: torch.Tensor | None = None,
                  row_mask: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched cyclic sweep; returns new (X, R).

    A_t (n_blocks, B, m), X (n_blocks, L, B), R (L, m), steps (n_blocks,),
    lam1s (L,), row_mask None or (m,) 0/1, all f32; keep_mask None or (n,)
    bool.  ``penalty`` gives the kind (and group weights; a group_l2 block
    holds whole groups); its lam1 is ignored in favour of lam1s.  CPU
    tensors take the plain version; CUDA tensors launch K5 or raise."""
    if not _on_cuda(A_t):
        return batch_sweep_t_plain(A_t, X, R, steps, lam1s, lam2, penalty,
                                   keep_mask, row_mask)
    if penalty.kind not in KIND_CODE:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
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
    gsize, w = group_operands(penalty, nb * B, B, dev)
    if penalty.kind != "group_l2":
        gsize = 0
    plan = batch_plan(dev, B, m, L, gsize)
    if plan is None:
        raise ValueError(f"K5 tile of B={B}, m={m}, L={L} does not fit in "
                         "shared memory")
    # the tile's copies: bulk or 16-byte cp.async (the float4 instance on
    # an aligned A_t), else 4-byte cp.async
    copy = (2 if plan.bulk else 1) if plan.vec and _aligned(A_t) else 0
    X_out = torch.empty_like(X)
    R_out = torch.empty_like(R)
    partials = torch.empty(((plan.grid + 1) * L * B,), dtype=torch.float32,
                           device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)  # grid barrier
    err = _build.load().cot_batch_sweep_t(
        A_t.data_ptr(), X.data_ptr(), R.data_ptr(), steps.data_ptr(),
        lam1s.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(),
        None if w is None else w.data_ptr(),
        X_out.data_ptr(), R_out.data_ptr(), partials.data_ptr(),
        bar.data_ptr(), nb, B, m, L, plan.gsize, float(lam2),
        KIND_CODE[penalty.kind], plan.grid, plan.rows, plan.ld,
        plan.prefetch, plan.s1, plan.s2, plan.rw, int(plan.vec), copy,
        _build.stream_ptr(dev))
    _build.check(err, "batch_sweep_t")
    _build.launches["batch_sweep_t"] += 1
    return X_out, R_out


# -------------------------------------------------------------- K6, K7 ----

def matvec_batch_plan(device: torch.device, n: int, m: int,
                      L: int) -> tuple[int, int, int, int]:
    """K6's and K7's launch plan at (n, m, L) on ``device``, from the C
    side: (K6 slices S, K7 chunk width W, K7 chunks C, K7 CTAs per
    chunk).  K6 writes S partial rows per output row; K7 keeps W columns
    of R in shared memory and writes C partials per output when C > 1."""
    key = (device.index, n, m, L)
    if key not in _plan_cache:
        plan = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            _build.check(_build.load().cot_matvec_batch_plan(n, m, L, plan),
                         "cot_matvec_batch_plan")
        _plan_cache[key] = tuple(plan)
    return _plan_cache[key]


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
    slices = matvec_batch_plan(A_t.device, nb * B, m, L)[0]
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
    _, W, C, G = matvec_batch_plan(A_t.device, nb * B, m, L)
    Z = torch.empty_like(X)
    partials = (torch.empty((C,) + tuple(X.shape), dtype=torch.float32,
                            device=A_t.device) if C > 1 else None)
    err = _build.load().cot_neg_at_r_batch_t(
        A_t.data_ptr(), R.data_ptr(), X.data_ptr(), Z.data_ptr(),
        None if partials is None else partials.data_ptr(), nb, B, m, L, W,
        C, G, float(lam2), _build.stream_ptr(A_t.device))
    _build.check(err, "neg_at_r_batch_t")
    _build.launches["neg_at_r_batch_t"] += 1
    return Z
