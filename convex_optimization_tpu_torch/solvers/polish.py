"""f64 support polish with a full-problem certificate.

Counterpart of ``polish_support`` and ``_polish_support_group`` in
``convex_optimization_tpu/solvers/polish.py``.  The f32 solve has a
relative-gap floor of a few 1e-6; to certify 1e-6 the solve finishes on the
host in float64:

  1. restrict to the f32 solution's support S, of columns or for group_l2
     of whole groups (the unit, ``_Unit``), and gather its columns;
  2. cyclic f64 coordinate descent on them (``_cd64``, over groups
     ``_cd64_group``; native when the library builds), or for l1 and
     nonneg_l1 on a card, on the columns gathered there (``_cd64_card``,
     K10 ``ops/cd64``): ``_executor`` picks the route from the problem's
     device, and the host route stays the CPU's and the parity oracle;
  3. certify on the FULL problem with a conservative dual norm: exact f64
     on the gathered columns, the device's f32 witness plus a rounding
     margin gamma * ||A_j|| * ||r|| on every other column (for a group, the
     norm of those per-column bounds).  The margin can only inflate the
     gap, so a certificate that passes is sound;
  4. if it misses tol, refine near-boundary units exactly, then expand S
     and repeat.

The device witness is K3 (``ops/matvec.neg_at_r_t``), and gamma comes from
K3's stated summation depth (``ops/matvec.witness_gamma``): the JAX
package's ``A.T @ r`` by XLA had an assumed O(log m) depth, a cuBLAS gemv
has none that is stated.  Column norms are computed once per call, in f64,
from ``A_t``.  The host helpers are copies of the JAX module's (its
package imports jax, which the port may not).
"""

from __future__ import annotations

import contextlib
import functools
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.ops.cd64 import (
    block_gram64,
    cd64_atr_t,
    cd64_plan,
    cd64_residual_t,
    cd64_sweeps_t,
    support_slab,
)
from convex_optimization_tpu_torch.ops.matvec import neg_at_r_t, witness_gamma
from convex_optimization_tpu_torch.utils import native
from convex_optimization_tpu_torch.utils.trace import CpuSpan, span


class PolishResult(NamedTuple):
    x: np.ndarray          # (n,) float64 polished solution
    rel_gap: float         # f64-certified relative duality gap (full problem)
    gap: float
    primal: float
    kept: int              # columns in the final support set
    iterations: int        # f64 CD sweeps
    wall_time_s: float     # the span ``cot.polish`` (polish_support)
    gather_s: float = 0.0  # seconds spent gathering the support's columns
                           # (the ``cot.polish.gather`` spans)


class _NpPenalty:
    """NumPy twin of the Penalty (f64, host-side); group_l2 over
    ``ngroups`` contiguous equal groups with weights ``w`` (ones when
    None)."""

    def __init__(self, kind: str, lam1: float, ngroups: int = 0,
                 weights: np.ndarray | None = None):
        self.kind, self.lam1, self.ngroups = kind, lam1, ngroups
        self.w = None
        if kind == "group_l2":
            self.w = (np.ones(ngroups) if weights is None
                      else np.asarray(weights, np.float64))

    def _g(self, x):
        return x.reshape(self.ngroups, -1)

    def value(self, x):
        if self.kind == "group_l2":
            gn = np.linalg.norm(self._g(x), axis=1)
            return self.lam1 * (self.w * gn).sum()
        return self.lam1 * np.abs(x).sum()

    def prox(self, v, t):
        tl = t * self.lam1
        if self.kind == "l1":
            return np.sign(v) * np.maximum(np.abs(v) - tl, 0.0)
        if self.kind == "nonneg_l1":
            return np.maximum(v - tl, 0.0)
        vg = self._g(v)
        gn = np.linalg.norm(vg, axis=1, keepdims=True)
        scale = np.maximum(0.0, 1.0 - tl * self.w[:, None]
                           / np.maximum(gn, 1e-300))
        return (vg * scale).reshape(v.shape)

    def dual_norm(self, z):
        if self.kind == "l1":
            return np.max(np.abs(z)) / self.lam1
        if self.kind == "nonneg_l1":
            return max(np.max(z), 0.0) / self.lam1
        gn = np.linalg.norm(self._g(z), axis=1)
        return np.max(gn / self.w) / self.lam1

    def keep_mask(self, z, alpha, gap, col_norms):
        """The gap-safe sphere test at the witness alpha * z."""
        radius = np.sqrt(max(2.0 * gap, 0.0))
        witness = alpha * z
        if self.kind == "l1":
            return ~(np.abs(witness) + radius * col_norms < self.lam1)
        if self.kind == "nonneg_l1":
            return ~(witness + radius * col_norms < self.lam1)
        gn = np.linalg.norm(self._g(witness), axis=1)
        gcol = np.sqrt(self._g(col_norms ** 2).sum(axis=1))
        gdiscard = gn + radius * gcol < self.lam1 * self.w
        return ~np.repeat(gdiscard, len(z) // self.ngroups)

    def compact(self, keep):
        """(keep widened to whole groups, the penalty on the kept
        columns)."""
        if self.kind != "group_l2":
            return keep, _NpPenalty(self.kind, self.lam1)
        gkeep = self._g(keep).any(axis=1)
        keep = np.repeat(gkeep, len(keep) // self.ngroups)
        return keep, _NpPenalty("group_l2", self.lam1, int(gkeep.sum()),
                                self.w[gkeep])


def _gap_from_parts(r, b, lam2, pen, x, z=None, feas=None):
    """(gap, primal, rel_gap, alpha) in f64 from precomputed r and z, with
    the optimal feasible scaling alpha on the residual ray, capped by
    ``feas`` (default 1 / the dual norm of z)."""
    if feas is None:
        feas = 1.0 / max(float(pen.dual_norm(z)), 1e-300)
    aug = float(r @ r + lam2 * (x @ x))
    alpha = min(max(float(-(r @ b)) / max(aug, 1e-300), 0.0), feas)
    primal = 0.5 * aug + float(pen.value(x))
    dual = alpha * float(-(r @ b)) - 0.5 * alpha * alpha * aug
    gap = primal - dual
    rel = gap / max(abs(primal), np.finfo(np.float64).tiny)
    return gap, primal, rel, alpha


def _gather_cols(A, idx, dtype=np.float64):
    """Column gather (+ cast) from a column-major f32 matrix into an
    F-ordered output; returns (columns, path) with path "native" or
    "numpy"."""
    out = native.gather_cols(A, np.asarray(idx), dtype)
    if out is not None:
        return out, "native"
    out = np.zeros((A.shape[0], len(idx)), dtype, order="F")
    for k in range(0, len(idx), 64):     # cache-sized batches
        out[:, k:k + 64] = A[:, idx[k:k + 64]]
    return out, "numpy"


def _gemv_t_mixed(As32, r64, lam2=0.0, xs64=None, chunk=1024):
    """z = -(As^T r) - lam2 x in f64 from the f32-stored slab."""
    if As32.dtype == np.float32 and As32.flags.f_contiguous:
        xs_c = None if xs64 is None else np.ascontiguousarray(xs64)
        z = native.atr_mixed(As32, np.ascontiguousarray(r64), float(lam2),
                             xs_c)
        if z is not None:
            return z
    width = As32.shape[1]
    z = np.empty(width, np.float64)
    for c0 in range(0, width, chunk):
        c1 = min(c0 + chunk, width)
        z[c0:c1] = -(As32[:, c0:c1].astype(np.float64).T @ r64)
    if lam2 != 0.0 and xs64 is not None:
        z -= lam2 * xs64
    return z


def _residual_sparse32(As32, xs64, b64):
    """r = As xs - b in f64 over the nonzeros of xs."""
    if As32.dtype == np.float32 and As32.flags.f_contiguous:
        r = native.ax_sparse(As32, np.ascontiguousarray(xs64),
                             np.ascontiguousarray(b64))
        if r is not None:
            return r
    r = -b64.copy()
    for j in np.nonzero(xs64)[0]:
        r += xs64[j] * As32[:, j].astype(np.float64)
    return r


def _sparse_residual(A, x, b):
    """r = A x - b in f64 over the nonzeros of x (A may be f32)."""
    nz = np.nonzero(x)[0]
    if len(nz) == 0:
        return -np.asarray(b, np.float64)
    return _gather_cols(A, nz)[0] @ x[nz] - b


def _witness_and_colnorms(A, r, lam2, x, chunk_cols=2048,
                          need_colnorms=True):
    """One chunked f64 pass over the host A (kept f32, cast per chunk):
    z = -A^T r - lam2 x and sqrt(||A_j||^2 + lam2)."""
    n = A.shape[1]
    z = np.empty(n, np.float64)
    cn = np.empty(n, np.float64) if need_colnorms else None
    for c0 in range(0, n, chunk_cols):
        blk = A[:, c0:c0 + chunk_cols].astype(np.float64)
        z[c0:c0 + chunk_cols] = -(blk.T @ r)
        if need_colnorms:
            cn[c0:c0 + chunk_cols] = np.sqrt((blk * blk).sum(axis=0) + lam2)
    if lam2 != 0.0:
        z -= lam2 * x
    return z, cn


def _fista64(As, b, lam2, pen_s, xs, tol, max_iters, gap_every,
             rescreen_cushion: float = 0.0, L: float | None = None):
    """f64 FISTA with adaptive restart on the compacted problem (the JAX
    package's ``_fista64``).  Returns (x, keep_idx, iters, rel_gap, gap,
    primal, r); keep_idx maps the returned columns to the input columns.
    An f32-stored As runs mixed-precision products (f64 arithmetic on
    the exact f32 values; the residual over the nonzeros of x).  L=None
    backtracks (L only doubles) from max_j ||A_j||^2 + lam2, a lower
    bound of the Lipschitz constant.  rescreen_cushion > 0 re-screens
    l1/nonneg_l1 columns at every check with the radius sqrt(2 gap) +
    cushion, which keeps each drop valid for the final witness (the
    certificate extension of ``polish_fast``)."""
    keep_idx = np.arange(As.shape[1])

    def products(A_):
        if A_.dtype == np.float32:
            return (lambda v: -_gemv_t_mixed(A_, v),
                    lambda v: _residual_sparse32(A_, v, b))
        return (lambda v: A_.T @ v), (lambda v: A_ @ v - b)

    matT, resid = products(As)
    col_norms = np.sqrt(
        np.einsum("ij,ij->j", As, As, dtype=np.float64) + lam2)
    backtrack = L is None
    if backtrack:
        L = max(float((col_norms ** 2).max()), 1e-12)
    step = 1.0 / L
    xs = np.array(xs, np.float64, copy=True)
    x_prev = xs.copy()
    r = resid(xs)
    r_prev = r.copy()
    t_mom = 1.0
    k = 0
    rel = gap = primal = np.inf
    while k < max_iters:
        for _ in range(gap_every):
            t_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_mom * t_mom))
            beta = (t_mom - 1.0) / t_next
            y = xs + beta * (xs - x_prev)
            r_y = r + beta * (r - r_prev)
            g = matT(r_y) + lam2 * y
            while True:
                x_new = pen_s.prox(y - step * g, step)
                r_new = resid(x_new)
                if not backtrack:
                    break
                # majorizer test of the smooth part at y
                d = x_new - y
                lhs = 0.5 * (r_new @ r_new + lam2 * (x_new @ x_new))
                rhs = (0.5 * (r_y @ r_y + lam2 * (y @ y))
                       + float(g @ d) + 0.5 * L * float(d @ d))
                if lhs <= rhs * (1.0 + 1e-12) + 1e-300:
                    break
                L *= 2.0
                step = 1.0 / L
            if float((y - x_new) @ (x_new - xs)) > 0.0:
                t_next, x_prev, r_prev = 1.0, x_new, r_new
            else:
                x_prev, r_prev = xs, r
            xs, r, t_mom = x_new, r_new, t_next
            k += 1
        zs = -matT(r) - lam2 * xs
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        if rescreen_cushion > 0.0 and pen_s.kind in ("l1", "nonneg_l1"):
            radius = np.sqrt(2.0 * max(gap, 0.0)) + rescreen_cushion
            w = alpha * zs
            if pen_s.kind == "l1":
                w = np.abs(w)
            drop = w + radius * col_norms < pen_s.lam1
            if drop.any():
                keep = ~drop
                As, _ = _gather_cols(As, np.nonzero(keep)[0], As.dtype)
                xs, x_prev = xs[keep], x_prev[keep]
                col_norms = col_norms[keep]
                keep_idx = keep_idx[keep]
                matT, resid = products(As)
                # the dropped coordinates were zero: r is unchanged, and L
                # stays valid (a column subset's norm is no larger)
                r = resid(xs)
                r_prev = r.copy()
                t_mom = 1.0
    return xs, keep_idx, k, rel, gap, primal, r


def _cd64(As32, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
          rescreen: bool = True):
    """f64 cyclic coordinate descent on the compacted problem (exact
    per-column Lipschitz ||A_j||^2 + lam2; f32-stored slab, f64
    arithmetic) on the host.  Returns (x, keep_idx, sweeps, rel_gap, gap,
    primal, r, route); keep_idx maps the returned columns to the input
    columns, route is "native" or "numpy" (who ran the sweeps).  rescreen
    drops columns by the plain gap-safe sphere: the caller recomputes the
    full certificate, so drops never affect soundness."""
    m, width = As32.shape
    keep_idx = np.arange(width)
    col_sq = np.einsum("ij,ij->j", As32, As32, dtype=np.float64) + lam2
    col_norms = np.sqrt(col_sq)
    lam1 = pen_s.lam1
    nonneg = pen_s.kind == "nonneg_l1"
    xs = np.array(xs, np.float64, copy=True)   # both paths update in place
    r = np.ascontiguousarray(_residual_sparse32(As32, xs, b))
    ajbuf = np.empty(m, np.float64)
    sweeps = 0
    route = "numpy"
    rel = gap = primal = np.inf
    while sweeps < max_sweeps:
        if native.cd64_sweeps(As32, xs, r, col_sq, float(lam1), float(lam2),
                              nonneg, gap_every):
            sweeps += gap_every
            route = "native"
        else:
            for _ in range(gap_every):
                for j in range(As32.shape[1]):
                    np.copyto(ajbuf, As32[:, j])
                    xj = xs[j]
                    g = float(ajbuf @ r) + lam2 * xj
                    v = xj - g / col_sq[j]
                    tl = lam1 / col_sq[j]
                    if nonneg:
                        xn = v - tl if v > tl else 0.0
                    else:
                        xn = (v - tl if v > tl
                              else (v + tl if v < -tl else 0.0))
                    if xn != xj:
                        r += ajbuf * (xn - xj)
                        xs[j] = xn
                sweeps += 1
        r = _residual_sparse32(As32, xs, b)     # exact refresh
        zs = _gemv_t_mixed(As32, r, lam2, xs)
        gap, primal, rel, keep = _cd64_check(r, b, lam2, pen_s, xs, zs,
                                             col_norms, tol, rescreen)
        if rel <= tol:
            break
        if keep is not None:
            As32, _ = _gather_cols(As32, keep, As32.dtype)
            xs = xs[keep]
            col_sq, col_norms = col_sq[keep], col_norms[keep]
            keep_idx = keep_idx[keep]
    return xs, keep_idx, sweeps, rel, gap, primal, r, route


def _cd64_check(r, b, lam2, pen_s, xs, zs, col_norms, tol, rescreen):
    """The check of ``_cd64`` and ``_cd64_card`` from the exact r and
    z_S = -A_S^T r - lam2 x: (gap, primal, rel_gap, keep).  keep lists the
    columns to keep when the plain gap-safe sphere drops some (never one
    whose x is nonzero), else it is None, as it is once rel_gap <= tol or
    without ``rescreen``."""
    gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
    if rel <= tol or not rescreen:
        return gap, primal, rel, None
    radius = np.sqrt(2.0 * max(gap, 0.0))
    w = alpha * zs
    if pen_s.kind == "l1":
        w = np.abs(w)
    drop = (w + radius * col_norms < pen_s.lam1) & (xs == 0.0)
    return gap, primal, rel, (np.nonzero(~drop)[0] if drop.any() else None)


def _cd64_card(slab, B, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
               rescreen: bool = True):
    """``_cd64`` on the slab's device: K10's sweeps (``ops/cd64``) over the
    support slab (the len(xs) columns of A as the rows of ``slab``,
    zero-padded to a multiple of the block width B), the check's exact f64
    refresh r = A_S x - b and z_S = -A_S^T r - lam2 x there too.  The gap
    and the rescreen's decision are _cd64's, on the host, from r, z_S and
    x (one transfer a check); a rescreen compacts the slab on the device.
    Returns _cd64's tuple, route "card"."""
    dev = slab.device
    f64 = torch.float64
    m, k = len(b), len(xs)
    xs = np.asarray(xs, np.float64)
    b_dev = torch.from_numpy(b).to(dev)
    lam1 = float(pen_s.lam1)
    nonneg = pen_s.kind == "nonneg_l1"
    keep_idx = np.arange(k)
    gram = block_gram64(slab, B)
    col_sq = torch.diagonal(gram, dim1=1, dim2=2).reshape(-1) + lam2
    col_sq[k:] = 1.0
    col_norms = np.sqrt(col_sq[:k].cpu().numpy())
    x = torch.zeros((slab.shape[0],), dtype=f64, device=dev)
    x[:k] = torch.from_numpy(xs).to(dev)
    r_dev = cd64_residual_t(slab, x, b_dev)
    r = None
    sweeps = 0
    rel = gap = primal = np.inf
    while sweeps < max_sweeps:
        cd64_sweeps_t(slab, x, r_dev, col_sq, gram, lam1, lam2, nonneg,
                      gap_every)
        sweeps += gap_every
        r_dev = cd64_residual_t(slab, x, b_dev)       # exact refresh
        zs_dev = cd64_atr_t(slab, r_dev, x, lam2)[:k]
        packed = torch.cat([r_dev, zs_dev, x[:k]]).cpu().numpy()
        r, zs, xs = packed[:m], packed[m:m + k], packed[m + k:]
        gap, primal, rel, keep = _cd64_check(r, b, lam2, pen_s, xs, zs,
                                             col_norms, tol, rescreen)
        if rel <= tol:
            break
        if keep is not None:
            keep_t = torch.as_tensor(keep, device=dev)
            slab = support_slab(slab, keep_t, B)
            gram = block_gram64(slab, B)
            cs = torch.ones((slab.shape[0],), dtype=f64, device=dev)
            cs[:len(keep)] = col_sq[keep_t]
            col_sq = cs
            xk = torch.zeros_like(col_sq)
            xk[:len(keep)] = x[keep_t]
            x = xk
            xs, col_norms = xs[keep], col_norms[keep]
            keep_idx = keep_idx[keep]
            k = len(keep)
            # the dropped coordinates were zero: r is unchanged
    return xs, keep_idx, sweeps, rel, gap, primal, r, "card"


def _cd64_group(As32, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
                rescreen: bool = True):
    """f64 block coordinate descent over GROUPS on the compacted
    group-lasso problem: one prox-gradient step per group per visit with
    the group's own Lipschitz constant (an 8-step f32-data power
    iteration, inflated 2 %), Gauss-Seidel residual updates, the slab kept
    f32 and each group read in f64.  Returns ``_cd64``'s tuple, route
    "native" or "numpy"; rescreen drops whole zero groups by the gap-safe
    group sphere (sound: the caller recomputes the full certificate)."""
    m, width = As32.shape
    ng = pen_s.ngroups
    gsize = width // ng
    lam1 = pen_s.lam1
    w = np.ascontiguousarray(pen_s.w, np.float64)
    keep_idx = np.arange(width)
    xs = np.array(xs, np.float64, copy=True)
    r = np.ascontiguousarray(_residual_sparse32(As32, xs, b))
    col_sq = np.einsum("ij,ij->j", As32, As32, dtype=np.float64)
    L = native.group_power_l(As32, gsize, iters=8, safety=1.02, lam2=lam2)
    if L is None:
        L = np.empty(ng)
        for g in range(ng):
            Ag = As32[:, g * gsize:(g + 1) * gsize]
            v = (1.0 + 0.01 * np.arange(gsize) / gsize).astype(np.float32)
            v /= np.linalg.norm(v)
            for _ in range(8):
                u = Ag.T @ (Ag @ v)
                v = u / max(np.linalg.norm(u), 1e-30)
            u = Ag @ v
            L[g] = 1.02 * float(u.astype(np.float64) @ u) + lam2
    # an all-zero group with lam2 == 0 has L = 0: keep the prox finite
    L = np.maximum(L, 1e-30)
    gbuf = np.empty((m, gsize), np.float64, order="F")
    sweeps = 0
    route = "numpy"
    rel = gap = primal = np.inf
    prev_primal = np.inf
    while sweeps < max_sweeps:
        if native.cd64_group_sweeps(As32, gsize, xs, r,
                                    np.ascontiguousarray(L), w,
                                    float(lam1), float(lam2), gap_every):
            sweeps += gap_every
            route = "native"
        else:
            for _ in range(gap_every):
                for g in range(ng):
                    sl = slice(g * gsize, (g + 1) * gsize)
                    np.copyto(gbuf, As32[:, sl])
                    xg = xs[sl]
                    v = xg - (gbuf.T @ r + lam2 * xg) / L[g]
                    nv = float(np.linalg.norm(v))
                    scale = max(0.0, 1.0 - lam1 * w[g]
                                / (L[g] * max(nv, 1e-300)))
                    dx = scale * v - xg
                    if np.any(dx):
                        r += gbuf @ dx
                        xs[sl] = scale * v
                sweeps += 1
        r = _residual_sparse32(As32, xs, b)     # exact refresh
        zs = _gemv_t_mixed(As32, r, lam2, xs)
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        # the power estimate is a lower bound of lam_max(Ag^T Ag): a primal
        # that stops decreasing between checks means a step too long, so
        # halve every step (convergence only; the certificate never uses L)
        if primal > prev_primal * (1.0 + 1e-12):
            L = L * 2.0
        prev_primal = min(prev_primal, primal)
        if rescreen and ng > 1:
            radius = np.sqrt(2.0 * max(gap, 0.0))
            gn = np.linalg.norm((alpha * zs).reshape(ng, gsize), axis=1)
            gcol = np.sqrt(col_sq.reshape(ng, gsize).sum(axis=1)
                           + lam2 * gsize)
            gdrop = gn + radius * gcol < lam1 * w
            gdrop &= ~(xs.reshape(ng, gsize).any(axis=1))
            if gdrop.any():
                gkeep = ~gdrop
                keep = np.repeat(gkeep, gsize)
                As32, _ = _gather_cols(As32, np.nonzero(keep)[0],
                                       As32.dtype)
                xs = np.ascontiguousarray(xs[keep])
                col_sq = col_sq[keep]
                keep_idx = keep_idx[keep]
                L, w = L[gkeep], np.ascontiguousarray(w[gkeep])
                ng = int(gkeep.sum())
                pen_s = _NpPenalty("group_l2", lam1, ng, w)
                # dropped groups were identically 0: r is unchanged
    return xs, keep_idx, sweeps, rel, gap, primal, r, route


@contextlib.contextmanager
def _stage(name: str, verbose: bool, **attrs):
    """One stage of the polish: the span ``name`` with this thread's CPU
    seconds and minor faults, printed on stderr when ``verbose`` (cpu ~=
    wall with many faults means a page-fault storm, cpu << wall means the
    thread was descheduled)."""
    with CpuSpan(name, **attrs) as s:
        yield s
    if verbose:
        what = ",".join(f"{k}={v}" for k, v in s.attrs.items())
        label = name[len("cot.polish."):] + (f"({what})" if what else "")
        print(f"  polish[{label}] +{s.seconds:.2f}s (cpu +{s.cpu_s:.2f}s "
              f"minflt +{s.minflt})", file=sys.stderr)


def _device_columns(problem, idx: np.ndarray) -> np.ndarray:
    """Columns idx of A from the device, as an F-ordered f32 (m, k)."""
    rows = problem.A_rows[torch.as_tensor(idx, device=problem.device)]
    return rows.cpu().numpy().T


def _col_norms64(problem, chunk: int = 8192) -> np.ndarray:
    """||A_j|| in f64 for every column, from A_t in f64 chunks."""
    A_rows = problem.A_rows
    out = torch.empty((problem.n,), dtype=torch.float64,
                      device=problem.device)
    for c0 in range(0, problem.n, chunk):
        out[c0:c0 + chunk] = torch.linalg.vector_norm(
            A_rows[c0:c0 + chunk].to(torch.float64), dim=1)
    return out.cpu().numpy()


def polish_support(problem, x, *, tol: float = 1e-6,
                   max_iters: int = 20_000, gap_every: int = 4,
                   A_host: np.ndarray | None = None,
                   b_host: np.ndarray | None = None,
                   max_expand: int = 3, verbose: bool = False) -> PolishResult:
    """Support-restricted f64 refinement certified on the full problem
    (module docstring), over a ``_Unit``, on ``_executor``'s route.
    ``A_host``/``b_host``: host copies of the data (A column-major f32),
    so columns are gathered without device transfers.  ``x`` may be a
    tensor or an array.  The call is the span ``cot.polish``, its stages
    the spans ``cot.polish.setup`` and, in each expansion round
    (``cot.polish.round``), ``.gather``, ``.cd64`` (sweeps, route "card",
    "native" or "numpy", columns gathered, kept), ``.witness`` and
    ``.near``; ``verbose=True`` prints each stage's wall, CPU seconds and
    minor faults."""
    if problem.penalty.kind not in ("l1", "nonneg_l1", "group_l2"):
        return polish_fast(problem, x, tol=tol, max_iters=max_iters,
                           gap_every=gap_every, A_host=A_host, b_host=b_host)
    with span("cot.polish") as whole:
        pr, rounds = _polish_rounds(problem, x, tol, max_iters, gap_every,
                                    A_host, b_host, max_expand, verbose)
    whole.set(kept=pr.kept, rounds=rounds)
    return pr._replace(wall_time_s=whole.seconds)


class _Unit:
    """The support polish's unit, from the penalty's kind: a column (l1,
    nonneg_l1; its scale lam1) or a group (group_l2; its scale lam1 w_g,
    its bound the norm of its columns' bounds |z_j| + gamma ||A_j|| ||r||
    >= ||z_g||)."""

    def __init__(self, pen: _NpPenalty, n: int):
        self.pen, self.lam1 = pen, pen.lam1
        self.grouped = pen.kind == "group_l2"
        self.gsize = n // pen.ngroups if self.grouped else 1
        self.near_cap = 64 if self.grouped else 8192
        self.w = pen.w if self.grouped else 1.0   # the scale is lam1 * w

    def support(self, x):
        return np.nonzero(x.reshape(-1, self.gsize).any(axis=1))[0]

    def cols(self, units):
        return (units[:, None] * self.gsize
                + np.arange(self.gsize)[None, :]).reshape(-1)

    def penalty(self, units):
        if self.grouped:
            return _NpPenalty("group_l2", self.lam1, len(units),
                              self.w[units])
        return self.pen

    def bound(self, z, err):
        """Per-unit bounds of the dual norm's terms from z and its error."""
        zb = (np.maximum(z + err, 0.0) if self.pen.kind == "nonneg_l1"
              else np.abs(z) + err)
        if self.grouped:
            return np.sqrt((zb ** 2).reshape(-1, self.gsize).sum(axis=1))
        return zb

    def kept(self, units, sub_idx):
        """(the units the next round grows from, their positions among the
        gathered columns): the CD's dropped columns leave, groups stay."""
        return (units, slice(None)) if self.grouped \
            else (units[sub_idx], sub_idx)

    def pick(self, cand, ub_w, k):
        # no unit violates: the k of the largest ub / w, or (the JAX
        # package's group rule) the k // 2 lowest-numbered groups
        if self.grouped:
            return cand[:max(k // 2, 1)]
        return cand[np.argsort(-ub_w[cand])[:k]]


def _card_plan(problem):
    """The route of the support's CD and exact products: K10's plan when
    the problem lives on a card (the CD on the slab gathered there;
    ``cd64_plan`` raises where no layout fits m), None for the host route
    of a CPU problem (native, else NumPy)."""
    if problem.device.type != "cuda":
        return None
    return cd64_plan(problem.device, problem.m)


def _executor(problem, unit, A_host, lam2, gap_every):
    """(gather(cols) -> (A's columns or their slab, source), cd(_cd64's
    arguments) -> its tuple, exact_z(cols, r, As=None, x=None) -> f64
    -(A^T r) - lam2 x), chosen once per call: on the card for l1 and
    nonneg_l1 on a CUDA problem (``_card_plan``), else on the host."""
    dev = problem.device
    plan = None if unit.grouped else _card_plan(problem)
    if plan is not None:
        def gather(idx):
            slab = support_slab(problem.A_rows,
                                torch.as_tensor(idx, device=dev), plan.B)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return slab, "card"

        def exact_z(idx, r, As=None, x=None):
            return cd64_atr_t(
                problem.A_rows, torch.from_numpy(r).to(dev),
                None if x is None else torch.from_numpy(x).to(dev),
                lam2 if x is not None else 0.0,
                idx=torch.as_tensor(idx, device=dev)).cpu().numpy()

        return gather, lambda As, *a: _cd64_card(As, plan.B, *a), exact_z

    def gather(idx):
        if A_host is None:
            return _device_columns(problem, idx), "device"
        return _gather_cols(A_host, idx, np.float32)

    def exact_z(idx, r, As=None, x=None):
        if As is None:
            As, _ = gather(idx)
        return _gemv_t_mixed(As, r, lam2 if x is not None else 0.0, x)

    # the separable CD checks every 2 sweeps, as the JAX package's does
    return gather, (functools.partial(_cd64_group, gap_every=gap_every)
                    if unit.grouped else _cd64), exact_z


def _polish_rounds(problem, x, tol, max_iters, gap_every, A_host, b_host,
                   max_expand, verbose) -> tuple[PolishResult, int]:
    """The rounds of ``polish_support``: (the result with its wall left to
    the caller, the rounds run)."""
    n, dev = problem.n, problem.device
    with _stage("cot.polish.setup", verbose):
        lam1, lam2, pen, x_np, b = _host_inputs(problem, x, b_host)
        unit = _Unit(pen, n)
        w = unit.w
        gather, cd, exact_z = _executor(problem, unit, A_host, lam2,
                                        gap_every)
        U = unit.support(x_np) if x_np.any() else np.array([0])
        eps = float(np.finfo(np.float32).eps)
        gamma_cn = witness_gamma(problem.m) * (
            _col_norms64(problem) * (1.0 + 4 * eps) + 1e-12)
        zeros_n = torch.zeros((n,), dtype=torch.float32, device=dev)

    best, gather_s = None, 0.0
    for rounds in range(1, max_expand + 2):
        with span("cot.polish.round", index=rounds - 1):
            cols = unit.cols(U)
            with _stage("cot.polish.gather", verbose,
                        columns=len(cols)) as st:
                As, source = gather(cols)
                st.set(bytes=int(As.nbytes), source=source)
            gather_s += st.seconds
            pen_s = unit.penalty(U)
            with _stage("cot.polish.cd64", verbose) as st:
                xs, sub_idx, k, _, _, _, r, route = cd(
                    As, b, lam2, pen_s, x_np[cols], tol * 0.5, max_iters)
                st.set(sweeps=k, route=route, columns=len(cols),
                       kept=len(sub_idx))
            x_cols = np.zeros(len(cols), np.float64)
            x_cols[sub_idx] = xs
            U_kept, pos = unit.kept(U, sub_idx)
            xk = x_cols[pos]

            # full-problem certificate: f32 K3 witness + margin on every
            # column, exact f64 on the gathered ones
            with _stage("cot.polish.witness", verbose):
                r32 = torch.from_numpy(r.astype(np.float32)).to(dev)
                z = neg_at_r_t(problem.A_t, r32, zeros_n, 0.0) \
                    .cpu().numpy().astype(np.float64)
                err = gamma_cn * float(np.linalg.norm(r))
                z[cols] = exact_z(cols, r, As, x_cols)
                err[cols] = 0.0
                ub = unit.bound(z, err)

            def certify(ub_now):
                # ub_now bounds each unit's dual norm: the feasibility cap
                # lam1 / max(ub / w) is conservative
                return _gap_from_parts(r, b, lam2, pen_s, xk, feas=lam1 / max(
                    float(np.max(ub_now / w)), 1e-300))[:3]

            gap, primal, rel = certify(ub)
            if rel > tol:
                # the margin may be all that pushes near-boundary units
                # over: replace their bounds with exact f64 values
                near = np.setdiff1d(
                    np.nonzero(ub >= lam1 * w * (1.0 - 1e-6))[0], U)
                if len(near) > unit.near_cap:
                    near = near[np.argsort(-(ub / w)[near])[:unit.near_cap]]
                if len(near):
                    near_cols = unit.cols(near)
                    with _stage("cot.polish.near", verbose,
                                columns=len(near_cols)):
                        ub[near] = unit.bound(exact_z(near_cols, r), 0.0)
                        gap, primal, rel = certify(ub)
            if best is None or rel < best[3]:
                best = (xk.copy(), cols[pos].copy(), k, rel, gap, primal)
            if rel <= tol:
                break
            # expand with the violating / nearest-boundary units
            outside = np.setdiff1d(
                np.nonzero(ub >= lam1 * w * (1.0 - 1e-9))[0], U_kept)
            if len(outside) == 0:
                cand = np.setdiff1d(np.argsort(-(ub / w))[:2 * len(U_kept)],
                                    U_kept)
                if len(cand) == 0:
                    break
                outside = unit.pick(cand, ub / w, len(U_kept))
            x_np = np.zeros(n, np.float64)
            x_np[cols[pos]] = xk
            U = np.sort(np.concatenate([U_kept, outside]))

    xk, kcols, k, rel, gap, primal = best
    x_full = np.zeros(n, dtype=np.float64)
    x_full[kcols] = xk
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=len(kcols), iterations=k, wall_time_s=0.0, gather_s=gather_s,
    ), rounds


def _host_inputs(problem, x, b_host):
    """(lam1, lam2, the _NpPenalty, x in f64, b in f64) on the host."""
    pen = problem.penalty
    w = None if pen.weights is None else pen.weights.detach().cpu().numpy()
    lam1 = float(pen.lam1)
    x_np = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)
    b = np.asarray(problem.b.cpu().numpy() if b_host is None else b_host,
                   dtype=np.float64)
    return (lam1, float(problem.lam2),
            _NpPenalty(pen.kind, lam1, pen.ngroups, w), x_np, b)


def polish(problem, x, *, tol: float = 1e-6, max_iters: int = 20_000,
           gap_every: int = 10, A_host: np.ndarray | None = None,
           b_host: np.ndarray | None = None) -> PolishResult:
    """Refine x to an f64-certified relative gap <= tol: the belt-and-
    braces oracle (JAX ``solvers/polish.polish``).  Two chunked f64 host
    passes over A: the gap-safe screen at x (f64 certificate), then, after
    ``_fista64`` on the kept columns, the full-problem certificate.
    ``A_host``/``b_host``: host copies of the data (else A is copied from
    the device)."""
    t0 = time.perf_counter()
    # without a host copy, A comes from the device once (column-major)
    A = (problem.A_rows.detach().cpu().numpy().T if A_host is None
         else np.asarray(A_host))
    lam1, lam2, pen, x0, b = _host_inputs(problem, x, b_host)
    n = A.shape[1]
    r0 = _sparse_residual(A, x0, b)
    z, col_norms = _witness_and_colnorms(A, r0, lam2, x0)
    gap0, _, _, alpha = _gap_from_parts(r0, b, lam2, pen, x0, z)
    keep, pen_s = pen.compact(pen.keep_mask(z, alpha, gap0, col_norms))
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        # x* = 0 is certified: keep one column so the machinery runs
        keep[:1] = True
        keep, pen_s = pen.compact(keep)
        idx = np.nonzero(keep)[0]
    As, _ = _gather_cols(A, idx)
    xs, sub_idx, k, _, _, _, r = _fista64(
        As, b, lam2, pen_s, x0[idx], tol, max_iters, gap_every)
    idx = idx[sub_idx]
    x_full = np.zeros(n, dtype=np.float64)
    x_full[idx] = xs
    z_f, _ = _witness_and_colnorms(A, r, lam2, x_full, need_colnorms=False)
    gap, primal, rel, _ = _gap_from_parts(r, b, lam2, pen, x_full, z_f)
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(idx)), iterations=k,
        wall_time_s=time.perf_counter() - t0)


def _device_witness(problem, x_np: np.ndarray, b: np.ndarray, lam2: float,
                    pen: _NpPenalty):
    """The full-width pieces of ``polish_fast``'s device variant: r = A x
    - b in f64 on the device over the nonzeros of x; z = -A^T r - lam2 x
    from K3's f32 A^T r (the lam2 term in f64); the f64 column norms; and
    a per-column bound err with |z_j - z_exact_j| <= err_j: K3's
    ``witness_gamma(m) ||A_j|| ||r||`` (its plain version on the CPU is
    inside it), except on the columns whose bound could reach the dual
    norm (those of the largest witnesses), which are recomputed exactly in
    f64 on the device (err_j = 0).  So theta0's scaling can be feasible
    against the bound without being cut by the margin."""
    dev = problem.device
    S = np.nonzero(x_np)[0]
    r_dev = -torch.as_tensor(b, dtype=torch.float64, device=dev)
    for c0 in range(0, len(S), 8192):
        cols = torch.as_tensor(S[c0:c0 + 8192], device=dev)
        r_dev += problem.A_rows[cols].to(torch.float64).T \
            @ torch.as_tensor(x_np[S[c0:c0 + 8192]], device=dev)
    dt = problem.dtype
    zeros_n = torch.zeros((problem.n,), dtype=dt, device=dev)
    z = neg_at_r_t(problem.A_t, r_dev.to(dt), zeros_n, 0.0) \
        .cpu().numpy().astype(np.float64) - lam2 * x_np
    cn = _col_norms64(problem)
    eps = float(np.finfo(np.float32).eps)
    err = witness_gamma(problem.m) * (cn * (1.0 + 4 * eps) + 1e-12) \
        * float(torch.linalg.vector_norm(r_dev))
    if pen.kind == "group_l2":
        raw = np.linalg.norm(pen._g(z), axis=1) / pen.w
        ub = np.linalg.norm(pen._g(np.abs(z) + err), axis=1) / pen.w
        gs = problem.n // pen.ngroups
        near = np.nonzero(ub >= raw.max())[0]
        near = (near[:, None] * gs + np.arange(gs)).reshape(-1)
    else:
        zs = np.abs(z) if pen.kind == "l1" else z
        near = np.nonzero(zs + err >= zs.max())[0]
    for c0 in range(0, len(near), 8192):
        idx = near[c0:c0 + 8192]
        cols = torch.as_tensor(idx, device=dev)
        z[idx] = -(problem.A_rows[cols].to(torch.float64) @ r_dev) \
            .cpu().numpy() - lam2 * x_np[idx]
        err[idx] = 0.0
    return r_dev.cpu().numpy(), z, cn, err


def polish_fast(problem, x, *, tol: float = 1e-6, max_iters: int = 20_000,
                gap_every: int = 4, A_host: np.ndarray | None = None,
                b_host: np.ndarray | None = None) -> PolishResult:
    """Certified refinement with no full-width f64 pass over A (JAX
    ``solvers/polish.polish_fast``).

    The dual is 1-strongly concave, so a feasible theta0 with gap g0 lies
    within sqrt(2 g0) of theta*, and the compact solve's witness within
    sqrt(2 g_hat) of it: screening at theta0 with the radius
    R = sqrt(2 g0) + sqrt(2 g_hat) (g_hat <= tol P, known a priori)
    certifies every discarded column for the final witness, so the compact
    certificate extends to the full problem.

    With ``A_host`` the screen is one chunked f64 host pass.  Without it,
    the device variant (``_device_witness``): the f32 witness is K3 on
    the problem's device (its plain version on the CPU), inflated by K3's
    rounding bound ``witness_gamma(m) ||A_j|| ||r||`` before use, but
    exact in f64 on the columns whose bound could reach the dual norm;
    theta0's scaling is feasible against these bounds, and r and the gap
    are f64.  The gap is inflated as the JAX package inflates it.  The
    kept columns come from the device; ``_fista64`` backtracks on them."""
    t0 = time.perf_counter()
    m, n = problem.m, problem.n
    lam1, lam2, pen, x_np0, b64 = _host_inputs(problem, x, b_host)
    if A_host is not None:
        r0 = _sparse_residual(A_host, x_np0, b64)
        z0, cn = _witness_and_colnorms(A_host, r0, lam2, x_np0)
        eps = float(np.finfo(np.float64).eps)
        gamma = (math.ceil(math.log2(max(m, 2))) + 4) * eps
        z_err = None
    else:
        r0, z0, cn, z_err = _device_witness(problem, x_np0, b64, lam2, pen)
        cn = np.sqrt(cn ** 2 + lam2)
        eps = float(np.finfo(np.float32).eps)
        gamma = witness_gamma(m)
    # rounding inflation: |delta z_j| <= gamma ||A_j|| ||r|| (z_err), the
    # column norms by 4 eps, the gap (as the JAX package inflates it) by
    # 1.25 and gamma |P|
    cn_safe = cn * (1.0 + 4 * eps) + 1e-12
    if z_err is None:
        z_err = gamma * cn_safe * float(np.linalg.norm(r0))
    ub = np.abs(z0) + z_err
    if pen.kind == "nonneg_l1":
        ub = np.maximum(z0 + z_err, 0.0)
    # theta0 = alpha0 * rho0 is feasible against the inflated witness
    gap0, primal0, _, alpha0 = _gap_from_parts(r0, b64, lam2, pen, x_np0,
                                               ub)
    gap_safe = 1.25 * abs(gap0) + gamma * abs(primal0)
    cushion = float(np.sqrt(2.0 * tol * abs(primal0) * 1.5))
    radius = np.sqrt(2.0 * gap_safe) + cushion
    if pen.kind == "l1":
        discard = np.abs(alpha0 * z0) + alpha0 * z_err \
            + radius * cn_safe < lam1
    elif pen.kind == "nonneg_l1":
        discard = alpha0 * (z0 + z_err) + radius * cn_safe < lam1
    else:
        gw = np.linalg.norm(pen._g(np.abs(alpha0 * z0) + alpha0 * z_err),
                            axis=1)
        gcn = np.sqrt(pen._g(cn_safe ** 2).sum(axis=1))
        discard = np.repeat(gw + radius * gcn < lam1 * pen.w,
                            n // pen.ngroups)
    keep, pen_s = pen.compact(~discard)
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        keep[:1] = True
        keep, pen_s = pen.compact(keep)
        idx = np.nonzero(keep)[0]
    if A_host is None:
        As = _device_columns(problem, idx)
        if As.dtype != np.float32:
            As = np.asfortranarray(As, np.float64)
    else:
        As, _ = _gather_cols(A_host, idx)
    xs, sub_idx, k, rel, gap, primal, _ = _fista64(
        As, b64, lam2, pen_s, x_np0[idx], tol, max_iters, gap_every,
        rescreen_cushion=cushion)
    x_full = np.zeros(n, dtype=np.float64)
    x_full[idx[sub_idx]] = xs
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(idx)), iterations=k,
        wall_time_s=time.perf_counter() - t0)
