"""f64 support polish with a full-problem certificate.

Counterpart of ``polish_support`` in ``convex_optimization_tpu/solvers/
polish.py`` (l1 and nonneg_l1; ``_polish_support_group`` comes with
ROADMAP queue 1, item 8).  The f32 solve has a relative-gap floor of a few
1e-6; to certify 1e-6 the solve finishes on the host in float64:

  1. restrict to the f32 solution's support S and gather those columns;
  2. cyclic f64 coordinate descent on them (``_cd64``, native when the
     library builds);
  3. certify on the FULL problem with a conservative dual norm: exact f64
     on the gathered columns, the device's f32 witness plus a rounding
     margin gamma * ||A_j|| * ||r|| on every other column.  The margin can
     only inflate the gap, so a certificate that passes is sound;
  4. if it misses tol, refine near-boundary columns exactly, then expand S
     and repeat.

The device witness is K3 (``ops/matvec.neg_at_r_t``), and gamma comes from
K3's stated summation depth (``ops/matvec.witness_gamma``): the JAX
package's ``A.T @ r`` by XLA had an assumed O(log m) depth, a cuBLAS gemv
has none that is stated.  Column norms are computed once per call, in f64,
from ``A_t``.  The host helpers are copies of the JAX module's (its
package imports jax, which the port may not).
"""

from __future__ import annotations

import resource
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from convex_optimization_tpu_torch.ops.matvec import neg_at_r_t, witness_gamma
from convex_optimization_tpu_torch.utils import native


class PolishResult(NamedTuple):
    x: np.ndarray          # (n,) float64 polished solution
    rel_gap: float         # f64-certified relative duality gap (full problem)
    gap: float
    primal: float
    kept: int              # columns in the final support set
    iterations: int        # f64 CD sweeps
    wall_time_s: float


class _NpPenalty:
    """NumPy twin of the l1 / nonneg_l1 Penalty (f64, host-side)."""

    def __init__(self, kind: str, lam1: float):
        self.kind, self.lam1 = kind, lam1

    def value(self, x):
        return self.lam1 * np.abs(x).sum()

    def dual_norm(self, z):
        if self.kind == "l1":
            return np.max(np.abs(z)) / self.lam1
        return max(np.max(z), 0.0) / self.lam1


def _gap_from_parts(r, b, lam2, pen, x, z):
    """(gap, primal, rel_gap, alpha) in f64 from precomputed r and z, with
    the optimal feasible scaling alpha on the residual ray."""
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


def _cd64(As32, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
          rescreen: bool = True):
    """f64 cyclic coordinate descent on the compacted problem (exact
    per-column Lipschitz ||A_j||^2 + lam2; f32-stored slab, f64
    arithmetic).  Returns (x, keep_idx, sweeps, rel_gap, gap, primal, r);
    keep_idx maps the returned columns to the input columns.  rescreen
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
    rel = gap = primal = np.inf
    while sweeps < max_sweeps:
        if native.cd64_sweeps(As32, xs, r, col_sq, float(lam1), float(lam2),
                              nonneg, gap_every):
            sweeps += gap_every
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
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        if rescreen:
            radius = np.sqrt(2.0 * max(gap, 0.0))
            w = alpha * zs
            drop = ((np.abs(w) + radius * col_norms < lam1)
                    if not nonneg else (w + radius * col_norms < lam1))
            drop &= xs == 0.0
            if drop.any():
                keep = ~drop
                As32, _ = _gather_cols(As32, np.nonzero(keep)[0], As32.dtype)
                xs = xs[keep]
                col_sq, col_norms = col_sq[keep], col_norms[keep]
                keep_idx = keep_idx[keep]
    return xs, keep_idx, sweeps, rel, gap, primal, r


class _Ticker:
    """Per-phase wall, this-thread CPU and minor-fault deltas on stderr
    (verbose only): cpu ~= wall with many faults means a page-fault storm,
    cpu << wall means the thread was descheduled."""

    def __init__(self, verbose: bool):
        self.verbose = verbose
        self.t = time.perf_counter()
        self.prev = self._usage()

    @staticmethod
    def _usage():
        who = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)
        return time.thread_time(), resource.getrusage(who).ru_minflt

    def __call__(self, label: str) -> None:
        now, usage = time.perf_counter(), self._usage()
        if self.verbose:
            print(f"  polish[{label}] +{now - self.t:.2f}s "
                  f"(cpu +{usage[0] - self.prev[0]:.2f}s "
                  f"minflt +{usage[1] - self.prev[1]})", file=sys.stderr)
        self.t, self.prev = now, usage


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
    (module docstring).  ``A_host``/``b_host``: host copies of the data
    (A column-major f32), so columns are gathered without device
    transfers.  ``x`` may be a tensor or an array."""
    kind = problem.penalty.kind
    if kind not in ("l1", "nonneg_l1"):
        raise NotImplementedError(
            f"polish_support for {kind!r} is not ported yet "
            "(ROADMAP queue 1, item 8)")
    t0 = time.perf_counter()
    tick = _Ticker(verbose)
    m, n = problem.m, problem.n
    lam1 = float(problem.penalty.lam1)
    lam2 = float(problem.lam2)
    pen = _NpPenalty(kind, lam1)
    b = np.asarray(problem.b.cpu().numpy() if b_host is None else b_host,
                   dtype=np.float64)
    x_np = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)
    S = np.nonzero(x_np)[0]
    if len(S) == 0:
        S = np.array([0])

    def columns(idx):
        if A_host is None:
            return _device_columns(problem, idx), "device"
        return _gather_cols(A_host, idx, np.float32)

    eps = float(np.finfo(np.float32).eps)
    gamma = witness_gamma(m)
    cn_safe = _col_norms64(problem) * (1.0 + 4 * eps) + 1e-12
    zeros_n = torch.zeros((n,), dtype=torch.float32, device=problem.device)
    tick("setup")

    best = None
    for _round in range(max_expand + 1):
        As, path = columns(S)
        tick(f"gather(|S|={len(S)},{path})")
        S_full = S
        pen_s = _NpPenalty(kind, lam1)
        xs = x_np[S]
        xs, sub_idx, k, _, _, _, r = _cd64(
            As, b, lam2, pen_s, xs, tol * 0.5, max_iters)
        S = S[sub_idx]
        tick(f"cd64(sweeps={k})")

        # full-problem certificate: f32 K3 witness + margin everywhere,
        # exact f64 on the gathered set
        r32 = torch.from_numpy(r.astype(np.float32)).to(problem.device)
        z_f32 = neg_at_r_t(problem.A_t, r32, zeros_n, 0.0) \
            .cpu().numpy().astype(np.float64)
        tick("device-witness")
        if lam2 != 0.0:
            xfull32 = np.zeros(n, np.float32)
            xfull32[S] = xs.astype(np.float32)
            z_f32 -= lam2 * xfull32
        margin = gamma * cn_safe * float(np.linalg.norm(r))
        ub = (np.abs(z_f32) + margin if kind == "l1"
              else np.maximum(z_f32 + margin, 0.0))
        x_sf = np.zeros(len(S_full), np.float64)
        x_sf[sub_idx] = xs
        z_S = _gemv_t_mixed(As, r, lam2, x_sf)
        ub[S_full] = np.abs(z_S) if kind == "l1" else np.maximum(z_S, 0.0)

        def certify(ub_now):
            # ub_now upper-bounds the dual norm: the feasibility cap
            # lam1 / max(ub) is conservative
            feas = lam1 / max(float(ub_now.max()), 1e-300)
            aug = float(r @ r + lam2 * (xs @ xs))
            alpha = min(max(float(-(r @ b)) / max(aug, 1e-300), 0.0), feas)
            primal = 0.5 * aug + float(pen_s.value(xs))
            dual = alpha * float(-(r @ b)) - 0.5 * alpha * alpha * aug
            gap = primal - dual
            return gap / max(abs(primal), np.finfo(np.float64).tiny), gap, \
                primal

        rel, gap, primal = certify(ub)
        if rel > tol:
            # the margin may be all that pushes near-boundary columns over:
            # replace their witnesses with exact f64 values
            near = np.setdiff1d(
                np.nonzero(ub >= lam1 * (1.0 - 1e-6))[0], S_full)
            if len(near) > 8192:
                near = near[np.argsort(-ub[near])[:8192]]
            if len(near):
                A_near, _ = columns(near)
                z_near = _gemv_t_mixed(A_near, r)
                tick(f"near-exact(|near|={len(near)})")
                ub[near] = (np.abs(z_near) if kind == "l1"
                            else np.maximum(z_near, 0.0))
                rel, gap, primal = certify(ub)
        if best is None or rel < best[3]:
            best = (xs.copy(), S.copy(), k, rel, gap, primal)
        if rel <= tol:
            break
        # expand with the violating / nearest-boundary columns
        outside = np.setdiff1d(np.nonzero(ub >= lam1 * (1.0 - 1e-9))[0], S)
        if len(outside) == 0:
            cand = np.setdiff1d(np.argsort(-ub)[:2 * len(S)], S)
            if len(cand) == 0:
                break
            outside = cand[np.argsort(-ub[cand])[:len(S)]]
        x_np = np.zeros(n, np.float64)
        x_np[S] = xs
        S = np.sort(np.concatenate([S, outside]))

    xs, S, k, rel, gap, primal = best
    x_full = np.zeros(n, dtype=np.float64)
    x_full[S] = xs
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(S)), iterations=k,
        wall_time_s=time.perf_counter() - t0,
    )
