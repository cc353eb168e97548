"""K10: the f64 polish's cyclic coordinate descent over the support slab,
and the two f64 products of its check, on the card.

The kernels are in ``csrc/cd64.cu`` (its note gives the design).  They
replace no TPU kernel: the JAX package runs the same descent on the host
(``convex_optimization_tpu/solvers/polish.py`` ``_cd64``, natively
``co_cd64_sweeps``) because f64 on the TPU is emulated, and so does this
package's ``solvers/polish._cd64`` for a CPU problem.  Each wrapper below takes
its plain PyTorch version for CPU tensors and launches its kernel, or
raises, for CUDA tensors.

The support slab is the layout of ``A_t``: row j of ``slab`` (k, m) f32 is
column S_j of A, k padded with zero rows to a multiple of the block width
B; ``block_gram64`` gives each block's f64 Gram matrix, whose in-block
corrections make the blocked sweep exact (``cd64_sweeps_t_plain``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.matvec import _aligned, _check, _on_cuda

#: the widest block K10's serial warp takes (4 coordinates a lane)
CD64_MAX_B = 128


@dataclasses.dataclass(frozen=True)
class Cd64Plan:
    """K10's launch at one m on one card (``cot_cd64_plan``)."""
    B: int          # block width: coordinates per exchange
    grid: int       # CTAs, one per SM at most
    rows: int       # rows of r a CTA owns
    smem: int       # shared-memory bytes of a CTA


#: (device index, m) -> Cd64Plan
_plan_cache: dict = {}


def cd64_plan(device: torch.device, m: int) -> Cd64Plan:
    """K10's plan at m on ``device``: the widest B <= CD64_MAX_B whose
    layout fits shared memory.  Raises where none does: a CTA holds its
    rows of r in f64 beside a (B, B) f64 Gram block and two (B, rows) f32
    tiles, so past m of about 638 000 on 132 SMs no B >= 4 fits."""
    key = (device.index, m)
    if key not in _plan_cache:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            _build.check(_build.load().cot_cd64_plan(
                m, int(m % 4 == 0), CD64_MAX_B, out), "cot_cd64_plan")
        if out[0] == 0:
            raise ValueError(
                f"K10 has no layout at m = {m} on {device}: a CTA's rows "
                f"of r (f64), a 4 x 4 f64 Gram block and two 4-row f32 "
                f"tiles exceed its shared memory")
        _plan_cache[key] = Cd64Plan(*out)
    return _plan_cache[key]


def _vec(m: int, *ts: torch.Tensor) -> int:
    return int(m % 4 == 0 and _aligned(*ts))


# ----------------------------------------------------------- the slab ----

def support_slab(rows: torch.Tensor, idx: torch.Tensor,
                 B: int) -> torch.Tensor:
    """Rows ``idx`` of ``rows`` (n, m) f32, gathered on its device into a
    new (k, m) slab, k = len(idx) rounded up to a multiple of B, the pad
    rows zero."""
    k = len(idx)
    kp = -(-max(k, 1) // B) * B
    slab = torch.zeros((kp, rows.shape[1]), dtype=torch.float32,
                       device=rows.device)
    torch.index_select(rows, 0, idx, out=slab[:k])
    return slab


def block_gram64(slab: torch.Tensor, B: int,
                 chunk_bytes: int = 1 << 28) -> torch.Tensor:
    """G (k / B, B, B) f64 with G[j] = A_C A_C^T over block j's rows of the
    slab: exact f32 values, f64 sums.  A plain batched product, in chunks
    of blocks whose f64 copy stays under ``chunk_bytes``."""
    kp, m = slab.shape
    nb = kp // B
    blocks = slab.view(nb, B, m)
    G = torch.empty((nb, B, B), dtype=torch.float64, device=slab.device)
    step = max(1, chunk_bytes // (8 * B * m))
    for j0 in range(0, nb, step):
        a = blocks[j0:j0 + step].to(torch.float64)
        torch.bmm(a, a.mT, out=G[j0:j0 + step])
    return G


# --------------------------------------------------------- the sweeps ----

def cd64_sweeps_t_plain(slab: torch.Tensor, x: torch.Tensor,
                        r: torch.Tensor, col_sq: torch.Tensor,
                        gram: torch.Tensor, lam1: float, lam2: float,
                        nonneg: bool, sweeps: int) -> None:
    """Plain version of K10, in place on x and r: per block, g at the
    block's start, the block's coordinates in order with the in-block Gram
    correction, then r += A_C^T d_C (the model in ``csrc/cd64.cu``)."""
    B = gram.shape[1]
    for _ in range(sweeps):
        for j in range(slab.shape[0] // B):
            sl = slice(j * B, (j + 1) * B)
            A_C = slab[sl].to(torch.float64)
            g = (A_C @ r).tolist()
            Gj = gram[j].tolist()
            xc = x[sl].tolist()
            cs = col_sq[sl].tolist()
            d = [0.0] * B
            for i in range(B):
                v = xc[i] - (g[i] + lam2 * xc[i]) / cs[i]
                tl = lam1 / cs[i]
                if nonneg:
                    xn = v - tl if v > tl else 0.0
                else:
                    xn = v - tl if v > tl else (v + tl if v < -tl else 0.0)
                d[i] = xn - xc[i]
                if d[i] != 0.0:
                    xc[i] = xn
                    Gi = Gj[i]
                    for l_ in range(i + 1, B):
                        g[l_] += Gi[l_] * d[i]
            x[sl] = torch.tensor(xc, dtype=torch.float64, device=x.device)
            r += A_C.T @ torch.tensor(d, dtype=torch.float64,
                                      device=r.device)


def cd64_sweeps_t(slab: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                  col_sq: torch.Tensor, gram: torch.Tensor, lam1: float,
                  lam2: float, nonneg: bool, sweeps: int) -> None:
    """``sweeps`` cyclic f64 CD sweeps over the slab (k, m) f32, in place on
    x (k,) and r (m,) f64; col_sq (k,) f64 (pad entries 1), gram the
    slab's ``block_gram64`` (its B is the block width)."""
    if not _on_cuda(slab):
        return cd64_sweeps_t_plain(slab, x, r, col_sq, gram, lam1, lam2,
                                   nonneg, sweeps)
    k, m = slab.shape
    B = gram.shape[1]
    dev = slab.device
    f64 = torch.float64
    _check("slab", slab, (k, m), dev)
    for name, t, shape in (("x", x, (k,)), ("r", r, (m,)),
                           ("col_sq", col_sq, (k,)),
                           ("gram", gram, (k // B, B, B))):
        _check(name, t, shape, dev, f64)
    plan = cd64_plan(dev, m)
    if B > plan.B or B % 4 or k % B:
        raise ValueError(f"K10 takes no block of {B} at m = {m} "
                         f"(k = {k}; plan {plan})")
    # the coefficients of the prox, each an IEEE division as _cd64's
    coef = torch.stack([col_sq, 1.0 / col_sq, lam1 / col_sq])
    if not _aligned(slab, x, gram, coef):
        raise ValueError("K10 copies the slab, x and gram 16 bytes at a "
                         "time: they must be 16-byte aligned")
    partials = torch.empty((plan.grid * B,), dtype=f64, device=dev)
    d_g = torch.empty((B,), dtype=f64, device=dev)
    bar = torch.zeros((2,), dtype=torch.int32, device=dev)
    err = _build.load().cot_cd64_sweeps(
        slab.data_ptr(), x.data_ptr(), r.data_ptr(), coef.data_ptr(),
        gram.data_ptr(), partials.data_ptr(), d_g.data_ptr(),
        bar.data_ptr(), k, B, m, float(lam2), int(nonneg), int(sweeps),
        int(m % 4 == 0), _build.stream_ptr(dev))
    _build.check(err, "cd64_sweeps_t")
    _build.launches["cd64_sweeps_t"] += 1


# -------------------------------------------------------- the check ----

def cd64_residual_t_plain(slab: torch.Tensor, x: torch.Tensor,
                          b: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    r = -b.to(torch.float64)
    for c0 in range(0, slab.shape[0], chunk):
        r += slab[c0:c0 + chunk].to(torch.float64).T @ x[c0:c0 + chunk]
    return r


def cd64_residual_t(slab: torch.Tensor, x: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """r = A_S x - b in f64 from the slab (k, m) f32; x (k,), b (m,) f64."""
    if not _on_cuda(slab):
        return cd64_residual_t_plain(slab, x, b)
    k, m = slab.shape
    dev = slab.device
    _check("slab", slab, (k, m), dev)
    _check("x", x, (k,), dev, torch.float64)
    _check("b", b, (m,), dev, torch.float64)
    lib = _build.load()
    S = ctypes.c_int()
    with torch.cuda.device(dev):
        _build.check(lib.cot_cd64_residual_segments(k, m, ctypes.byref(S)),
                     "cot_cd64_residual_segments")
    part = torch.empty((S.value, m), dtype=torch.float64, device=dev)
    r = torch.empty((m,), dtype=torch.float64, device=dev)
    err = lib.cot_cd64_residual(slab.data_ptr(), x.data_ptr(), b.data_ptr(),
                                r.data_ptr(), part.data_ptr(), k, m, S.value,
                                _build.stream_ptr(dev))
    _build.check(err, "cd64_residual_t")
    _build.launches["cd64_residual_t"] += 1
    return r


def cd64_atr_t_plain(A: torch.Tensor, r: torch.Tensor,
                     x: torch.Tensor | None = None, lam2: float = 0.0,
                     idx: torch.Tensor | None = None,
                     chunk: int = 4096) -> torch.Tensor:
    count = A.shape[0] if idx is None else len(idx)
    z = torch.empty((count,), dtype=torch.float64, device=A.device)
    for c0 in range(0, count, chunk):
        rows = (A[c0:c0 + chunk] if idx is None
                else A[idx[c0:c0 + chunk]])
        z[c0:c0 + chunk] = -(rows.to(torch.float64) @ r)
    if x is not None:
        z -= lam2 * x
    return z


def cd64_atr_t(A: torch.Tensor, r: torch.Tensor,
               x: torch.Tensor | None = None, lam2: float = 0.0,
               idx: torch.Tensor | None = None) -> torch.Tensor:
    """z_j = -(A[idx_j] . r) - lam2 x_j in f64 (f32 rows of A (n, m), r (m,)
    f64; idx (count,) int64 or None for every row; x (count,) f64 or None
    for no lam2 term)."""
    if not _on_cuda(A):
        return cd64_atr_t_plain(A, r, x, lam2, idx)
    n, m = A.shape
    dev = A.device
    _check("A", A, (n, m), dev)
    _check("r", r, (m,), dev, torch.float64)
    count = n if idx is None else len(idx)
    if idx is not None:
        _check("idx", idx, (count,), dev, torch.int64)
    if x is not None:
        _check("x", x, (count,), dev, torch.float64)
    z = torch.empty((count,), dtype=torch.float64, device=dev)
    if count == 0:
        return z
    err = _build.load().cot_cd64_atr(
        A.data_ptr(), 0 if idx is None else idx.data_ptr(), r.data_ptr(),
        0 if x is None else x.data_ptr(), float(lam2), z.data_ptr(), count,
        m, _vec(m, A), _build.stream_ptr(dev))
    _build.check(err, "cd64_atr_t")
    _build.launches["cd64_atr_t"] += 1
    return z
