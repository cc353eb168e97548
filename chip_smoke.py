#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (convex_optimization_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  Phases, each of which fails the run if it fails:

  1. card and stack: nvidia-smi name and power limit, torch and CUDA;
  2. kernel build from csrc/ with nvcc (timed);
  3. each kernel (K1 sweep, K2 refresh, K3 witness, K4 block power)
     against its plain PyTorch version on the card, with stated
     tolerances: at a small shape, on a 64-block slice of the main path's
     A_t (B = 80, m = 10000), and on the full A_t (1250 blocks), where
     the kernel's and the plain version's times are taken with CUDA
     events; K1 runs with a partly-zero keep mask at the small and slice
     shapes and with the main path's all-ones mask at full size; then a
     200 x 800 solve + polish on the card against the same solve on the
     CPU (the plain versions);
  4. the main path of bench.py on the port: the native host library must
     have built (so the instance is the JAX package's, drawn by the same
     generator, and the polish runs its native f64 path); the 10k x 100k
     host instance,
     solve(method="bcd_pallas", tol=1e-6, max_iters=20000, gap_every=10,
     stall_checks=15, block_size=128), polish_support(..., A_host=A_np);
     the f64 certificate must reach rel_gap <= 1e-6, every kernel's launch
     count must have grown, and K3's rounding bound must hold for every
     column at the final polish residual;
  5. the batched kernels (K5 sweep, K6 refresh, K7 witness) against their
     plain versions, at a small shape and on config 2's A_t (625 x 80 x
     5000) with L = 10: K5 unmasked as the lambda path calls it, with a
     partly-zero keep mask and a fold row mask as CV calls it, the masked
     K5 against K5 on a masked copy of A_t (torch.equal), K5 at L = 1
     against K1; K5 timed at L = 1, 4, 10, 16;
  6. a 500 x 2000 10-point lambda path with bcd_batch and with bcd_pallas,
     on the card and on the CPU (plain versions): every converged point
     certifies in f64, supports agree between card and CPU;
  7. config 2 (5k x 50k, make_lasso_instance_host(0, ...)): the 10-point
     lambda_path(method="bcd_batch", tol=1e-6, max_iters=10000,
     gap_every=10, stall_checks=10, block_size=128), every point's f64
     rel_gap <= 1e-4 (the f32 floor of this configuration), then 5-fold
     cv_lambda_path on the same instance, its refit certified the same.

Every path reads the launch counts set to 0 just before it.  Prints a JSON
line per measured phase, one for the kernels, the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

SEED, M, N = 42, 10_000, 100_000
SOLVE_KW = dict(tol=1e-6, max_iters=20_000, gap_every=10, stall_checks=15,
                block_size=128)
# config 2: BASELINE.json:8; the settings of scripts/measure_config2.py
C2_SEED, C2_M, C2_N, C2_LEN = 0, 5_000, 50_000, 10
C2_CFG = dict(tol=1e-6, max_iters=10_000, gap_every=10, stall_checks=10,
              block_size=128)
C2_F32_FLOOR = 1e-4          # BASELINE.md:88
CV_K = 5
BATCH_L = 10
KERNELS = {
    "sweep_t": ("convex_optimization_tpu_torch/csrc/sweep.cu",
                "convex_optimization_tpu/ops/bcd_sweep_vpu.py:166"),
    "ax_minus_b_t": ("convex_optimization_tpu_torch/csrc/matvec.cu",
                     "convex_optimization_tpu/ops/matvec_pallas.py:42"),
    "neg_at_r_t": ("convex_optimization_tpu_torch/csrc/matvec.cu",
                   "convex_optimization_tpu/ops/matvec_pallas.py:66"),
    "block_power_t": ("convex_optimization_tpu_torch/csrc/matvec.cu",
                      "convex_optimization_tpu/ops/matvec_pallas.py:91"),
    "batch_sweep_t": ("convex_optimization_tpu_torch/csrc/sweep_batch.cu",
                      "convex_optimization_tpu/ops/bcd_sweep_vpu_batch.py:92"),
    "ax_minus_b_batch_t": (
        "convex_optimization_tpu_torch/csrc/matvec_batch.cu",
        "convex_optimization_tpu/ops/bcd_sweep_vpu_batch.py:267"),
    "neg_at_r_batch_t": (
        "convex_optimization_tpu_torch/csrc/matvec_batch.cu",
        "convex_optimization_tpu/ops/bcd_sweep_vpu_batch.py:318"),
}
MAIN_KERNELS = ("sweep_t", "ax_minus_b_t", "neg_at_r_t", "block_power_t")
PATH_KERNELS = ("block_power_t", "batch_sweep_t", "ax_minus_b_batch_t",
                "neg_at_r_batch_t")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs (after one warm-up), from
    CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def record(stats: dict, name: str, err: float, ms=None,
           plain_ms=None) -> None:
    """Keep a kernel's largest error over every check, and its times."""
    s = stats.setdefault(name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if ms is not None:
        s["ms"], s["plain_ms"] = ms, plain_ms


def compare_kernels(A_t, b, x_probe, keep, label: str, stats: dict,
                    timed: bool) -> None:
    """Every kernel against its plain version on one A_t; ``x_probe`` is
    a dense vector, ``keep`` K1's keep mask.

    Tolerances: f32 sums in another order than the plain versions', so
    one pass over A agrees to rounding (relative tol on the scale of the
    result); K1 chains n_blocks dependent updates, so the full-size sweep
    gets 1e-4 where a slice gets 1e-5; K4 gets 1e-4 (48 iterations)."""
    import torch

    from convex_optimization_tpu_torch.models.penalties import l1
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    zeros_n = torch.zeros(nb * B, device=A_t.device)

    # K4
    L_k = mv.block_power_t(A_t)
    L_p = mv.block_power_t_plain(A_t)
    err = float((L_k - L_p).abs().max())
    require(err <= 1e-4 * float(L_p.abs().max()),
            f"{label} block_power_t err {err}")
    times = (time_ms(lambda: mv.block_power_t(A_t), 1),
             time_ms(lambda: mv.block_power_t_plain(A_t), 1)) \
        if timed else (None, None)
    record(stats, "block_power_t", err, *times)

    # K2, row by row: |r_i - r'_i| <= 1e-5 (||A[i, :]|| ||x|| + |b_i|),
    # which bounds f32 rounding of a sum of n terms in any order; the limit
    # must be able to reject a kernel that returned zeros
    r_k = mv.ax_minus_b_t(A_t, x_probe, b)
    r_p = mv.ax_minus_b_t_plain(A_t, x_probe, b)
    row_tol = 1e-5 * (torch.linalg.vector_norm(A_t, dim=(0, 1)) * float(
        torch.linalg.vector_norm(x_probe)) + b.abs())
    diff = (r_k - r_p).abs()
    err = float(diff.max())
    require(bool((diff <= row_tol).all()),
            f"{label} ax_minus_b_t err {err}, worst ratio "
            f"{float((diff / row_tol).max())}")
    require(bool((r_p.abs() > row_tol).any()),
            f"{label} ax_minus_b_t limit cannot tell r from 0")
    times = (time_ms(lambda: mv.ax_minus_b_t(A_t, x_probe, b), 10),
             time_ms(lambda: mv.ax_minus_b_t_plain(A_t, x_probe, b), 10)) \
        if timed else (None, None)
    record(stats, "ax_minus_b_t", err, *times)

    # K3 (its stated bound, with ||A_j|| <= max column norm)
    z_k = mv.neg_at_r_t(A_t, r_p, zeros_n, 0.0)
    z_p = mv.neg_at_r_t_plain(A_t, r_p, zeros_n, 0.0)
    err = float((z_k - z_p).abs().max())
    col_max = float(torch.linalg.vector_norm(A_t, dim=2).max())
    bound = mv.witness_gamma(m) * col_max * float(
        torch.linalg.vector_norm(r_p))
    require(err <= bound, f"{label} neg_at_r_t err {err} > bound {bound}")
    times = (time_ms(lambda: mv.neg_at_r_t(A_t, r_p, zeros_n, 0.0), 10),
             time_ms(lambda: mv.neg_at_r_t_plain(A_t, r_p, zeros_n, 0.0),
                     10)) if timed else (None, None)
    record(stats, "neg_at_r_t", err, *times)

    # K1: one sweep from x = 0, r = -b, l1 at 0.1 lambda_max, with the
    # given keep mask (the main path passes all ones)
    lam1 = 0.1 * float(mv.neg_at_r_t_plain(A_t, b, zeros_n, 0.0).abs().max())
    pen = l1(lam1)
    steps = k1.block_steps(L_p, 0.0)
    x0, r0 = zeros_n, -b
    xk, rk = k1.sweep_t(A_t, x0, r0, steps, keep, pen, 0.0)
    xp, rp = k1.sweep_t_plain(A_t, x0, r0, steps, keep, pen, 0.0)
    require(bool((xk[~keep] == 0).all()), f"{label} sweep_t kept a masked x")
    sweep_tol = 1e-4 if nb > 64 else 1e-5
    ex = float((xk - xp).abs().max())
    er = float(torch.linalg.vector_norm(rk - rp))
    require(ex <= sweep_tol * max(1.0, float(xp.abs().max())),
            f"{label} sweep_t x err {ex}")
    require(er <= sweep_tol * float(torch.linalg.vector_norm(rp)),
            f"{label} sweep_t r err {er}")
    times = (time_ms(lambda: k1.sweep_t(A_t, x0, r0, steps, keep, pen, 0.0),
                     10),
             time_ms(lambda: k1.sweep_t_plain(A_t, x0, r0, steps, keep,
                                              pen, 0.0), 2)) \
        if timed else (None, None)
    record(stats, "sweep_t", max(ex, float((rk - rp).abs().max())), *times)
    torch.cuda.synchronize()
    log(f"# kernels vs plain [{label}] A_t={tuple(A_t.shape)}: ok")


def compare_batch_kernels(A_t, b, label: str, stats: dict,
                          timed: bool) -> dict:
    """K5, K6, K7 against their plain versions on one A_t at L = BATCH_L;
    returns K5's ms per sweep by L (empty unless ``timed``).

    Tolerances: one pass over A in another summation order, per element
    1e-5 (||A[i, :]|| ||x_l|| + |b_i|) for K6 and 1e-5 (||A_k|| ||r_l||
    + lam2 |x|) for K7; K5 as K1 (1e-5, 1e-4 past 64 blocks); the masked
    K5 equals K5 on a masked copy of A_t exactly."""
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.models.penalties import l1
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    n, L, dev = nb * B, BATCH_L, A_t.device
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    lam2 = 0.1

    # K6
    X = torch.randn(nb, L, B, generator=gen).to(dev)
    R_k = kb.ax_minus_b_batch_t(A_t, X, b)
    R_p = kb.ax_minus_b_batch_t_plain(A_t, X, b)
    row = torch.linalg.vector_norm(A_t, dim=(0, 1))
    xn = torch.linalg.vector_norm(kb.rows_of(X), dim=1)
    tol = 1e-5 * (xn[:, None] * row[None, :] + b.abs()[None, :])
    diff = (R_k - R_p).abs()
    require(bool((diff <= tol).all()),
            f"{label} ax_minus_b_batch_t worst ratio "
            f"{float((diff / tol).max())}")
    require(bool((R_p.abs() > tol).any()),
            f"{label} ax_minus_b_batch_t limit cannot tell R from 0")
    times = (time_ms(lambda: kb.ax_minus_b_batch_t(A_t, X, b), 10),
             time_ms(lambda: kb.ax_minus_b_batch_t_plain(A_t, X, b), 10)) \
        if timed else (None, None)
    record(stats, "ax_minus_b_batch_t", float(diff.max()), *times)

    # K7
    Z_k = kb.neg_at_r_batch_t(A_t, R_p, X, lam2)
    Z_p = kb.neg_at_r_batch_t_plain(A_t, R_p, X, lam2)
    col = torch.linalg.vector_norm(A_t, dim=2)
    rn = torch.linalg.vector_norm(R_p, dim=1)
    tolz = 1e-5 * (col[:, None, :] * rn[None, :, None] + lam2 * X.abs())
    diff = (Z_k - Z_p).abs()
    require(bool((diff <= tolz).all()),
            f"{label} neg_at_r_batch_t worst ratio "
            f"{float((diff / tolz).max())}")
    times = (time_ms(lambda: kb.neg_at_r_batch_t(A_t, R_p, X, lam2), 10),
             time_ms(lambda: kb.neg_at_r_batch_t_plain(A_t, R_p, X, lam2),
                     10)) if timed else (None, None)
    record(stats, "neg_at_r_batch_t", float(diff.max()), *times)

    # K5 from X = 0, R = -b (as a path starts), l1 on a geometric grid
    zeros_n = torch.zeros(n, device=dev)
    lmax = float(mv.neg_at_r_t_plain(A_t, b, zeros_n, 0.0).abs().max())
    lam1s = torch.as_tensor(np.geomspace(0.95, 0.01, L) * lmax,
                            dtype=torch.float32, device=dev)
    steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
    pen = l1(1.0)
    sweep_tol = 1e-4 if nb > 64 else 1e-5
    keep = (torch.rand(n, generator=gen) > 0.1).to(dev)
    rm = (torch.rand(m, generator=gen) > 0.2).to(torch.float32).to(dev)
    X0 = torch.zeros(nb, L, B, device=dev)
    R0 = (-b)[None, :].expand(L, m).contiguous()
    R0m = (-(rm * b))[None, :].expand(L, m).contiguous()
    err = 0.0

    def check(what, Xk, Rk, Xp, Rp):
        ex = float((Xk - Xp).abs().max())
        er = float(torch.linalg.vector_norm(Rk - Rp))
        require(ex <= sweep_tol * max(1.0, float(Xp.abs().max())),
                f"{label} batch_sweep_t {what} x err {ex}")
        require(er <= sweep_tol * float(torch.linalg.vector_norm(Rp)),
                f"{label} batch_sweep_t {what} r err {er}")
        return max(ex, float((Rk - Rp).abs().max()))

    # as the lambda path calls it: no keep mask, no row mask
    Xk, Rk = kb.batch_sweep_t(A_t, X0, R0, steps, lam1s, 0.0, pen)
    Xp, Rp = kb.batch_sweep_t_plain(A_t, X0, R0, steps, lam1s, 0.0, pen)
    err = max(err, check("unmasked", Xk, Rk, Xp, Rp))
    # as CV calls it: partly-zero keep mask and a fold row mask
    Xk, Rk = kb.batch_sweep_t(A_t, X0, R0m, steps, lam1s, 0.0, pen, keep, rm)
    Xp, Rp = kb.batch_sweep_t_plain(A_t, X0, R0m, steps, lam1s, 0.0, pen,
                                    keep, rm)
    err = max(err, check("masked", Xk, Rk, Xp, Rp))
    require(bool((kb.rows_of(Xk)[:, ~keep] == 0).all()),
            f"{label} batch_sweep_t kept a masked x")
    # the masked sweep against the sweep on a masked copy: bit for bit
    A_copy = A_t * rm
    X1, R1 = kb.batch_sweep_t(A_copy, X0, R0m, steps, lam1s, 0.0, pen, keep)
    X2, R2 = Xk, Rk
    for _ in range(2):
        X1, R1 = kb.batch_sweep_t(A_copy, X1, R1, steps, lam1s, 0.0, pen,
                                  keep)
        X2, R2 = kb.batch_sweep_t(A_t, X2, R2, steps, lam1s, 0.0, pen, keep,
                                  rm)
    require(torch.equal(X1, X2) and torch.equal(R1, R2),
            f"{label} masked batch_sweep_t differs from the masked copy")
    del A_copy
    # L = 1 against K1 on the same inputs
    X5, R5 = kb.batch_sweep_t(A_t, X0[:, :1].contiguous(), R0[:1].contiguous(),
                              steps, lam1s[:1].contiguous(), 0.0, pen, keep)
    x1, r1 = k1.sweep_t(A_t, zeros_n, -b, steps, keep, l1(float(lam1s[0])),
                        0.0)
    err = max(err, check("L=1 vs K1", X5[:, 0].reshape(n), R5[0], x1, r1))
    by_L = {}
    times = (None, None)
    if timed:
        for Lt in (1, 4, 10, 16):
            lam_t = torch.as_tensor(np.geomspace(0.95, 0.01, Lt) * lmax,
                                    dtype=torch.float32, device=dev)
            X_t = torch.zeros(nb, Lt, B, device=dev)
            R_t = (-b)[None, :].expand(Lt, m).contiguous()
            by_L[Lt] = time_ms(lambda: kb.batch_sweep_t(
                A_t, X_t, R_t, steps, lam_t, 0.0, pen), 5)
        by_L["k1"] = time_ms(lambda: k1.sweep_t(A_t, zeros_n, -b, steps,
                                                None, pen.with_lam1(
                                                    float(lam1s[0])), 0.0),
                             5)
        times = (by_L[BATCH_L],
                 time_ms(lambda: kb.batch_sweep_t_plain(
                     A_t, X0, R0, steps, lam1s, 0.0, pen), 1))
    record(stats, "batch_sweep_t", err, *times)
    torch.cuda.synchronize()
    log(f"# batched kernels vs plain [{label}] A_t={tuple(A_t.shape)} "
        f"L={L}: ok")
    return by_L


def certify(problem, res, tol: float) -> list:
    """f64 rel_gap, recomputed on the problem's device, of every path
    point in ``res`` (a PathResult)."""
    import convex_optimization_tpu_torch as cot

    return [float(cot.duality_gap(problem.with_lam1(lam), res.xs[l],
                                  precise=True).rel_gap)
            for l, lam in enumerate(res.lambdas.tolist())]


def small_path_reference(device) -> None:
    """500 x 2000, 10 points: lambda_path with bcd_batch and bcd_pallas on
    the card (kernels) and on the CPU (plain versions); every converged
    point certifies in f64 (<= 2 tol: the f32 gap's own rounding), and
    the supports (|x| > 1e-4) of points converged in both runs agree."""
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(**C2_CFG)
    inst_c, _, _ = make_lasso_instance_host(1, 500, 2000, device=device)
    inst_h, _, _ = make_lasso_instance_host(1, 500, 2000)
    out = {}
    for method in ("bcd_batch", "bcd_pallas"):
        runs = []
        for inst in (inst_c, inst_h):
            res = cot.lambda_path(inst.problem, cfg, path_len=C2_LEN,
                                  method=method)
            require(res.method_used == method,
                    f"small path ran {res.method_used}, not {method}")
            gaps = certify(inst.problem, res, cfg.tol)
            conv = res.converged.cpu().tolist()
            bad = [g for g, c in zip(gaps, conv) if c and g > 2 * cfg.tol]
            require(not bad, f"small {method} path: converged points "
                    f"with f64 gaps {bad}")
            runs.append((res, conv))
        (rc, cc), (rh, ch) = runs
        both = torch.tensor([a and b for a, b in zip(cc, ch)])
        same = (rc.xs.cpu().abs() > 1e-4) == (rh.xs.abs() > 1e-4)
        require(bool(same[both].all()),
                f"small {method} path: supports differ card vs CPU")
        out[method] = dict(card_sweeps=rc.sweeps, cpu_sweeps=rh.sweeps,
                           converged_card=sum(cc), converged_cpu=sum(ch))
    log(f"# small path reference 500x2000: {out}")


def config2_path(problem, gpu: str, power: str) -> dict:
    """Config 2's 10-point bcd_batch lambda path; every point's f64
    rel_gap must reach the f32 floor.  Returns the launch counts."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.ops.bcd_sweep import pick_block_size_t
    from convex_optimization_tpu_torch.ops.matvec import block_power_t
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    require(pick_block_size_t(C2_N, 128) == (80, 0),
            "config 2 block is not B = 80 without padding")
    A_t80 = problem.with_block(80).A_t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_power_t(A_t80)
    torch.cuda.synchronize()
    k4_s = time.perf_counter() - t0

    cfg = SolverConfig(**C2_CFG)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = cot.lambda_path(problem, cfg, path_len=C2_LEN, method="bcd_batch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(res.method_used == "bcd_batch",
            f"config-2 path ran {res.method_used}")
    for name in PATH_KERNELS + ("neg_at_r_t",):
        require(launches.get(name, 0) > 0, f"{name} never launched")
    require(launches.get("batch_sweep_t", 0) == res.sweeps,
            f"K5 launches {launches.get('batch_sweep_t', 0)} != sweeps "
            f"{res.sweeps}")
    require(res.xs.shape == (C2_LEN, C2_N)
            and bool(torch.isfinite(res.xs).all()), "config-2 path x")
    f64 = certify(problem, res, cfg.tol)
    require(max(f64) <= C2_F32_FLOOR, f"config-2 f64 gaps {f64}")
    passes = 1.0 + 2.0 / cfg.gap_every
    sweep_s = wall - k4_s
    print(json.dumps({
        "metric": f"config2_lambda_path_{C2_LEN}pt_bcd_batch_{C2_M}x{C2_N}",
        "L": C2_LEN,
        "sweeps": res.sweeps,
        "iters": res.iters.tolist(),
        "wall_s": wall,
        "k4_setup_s": k4_s,
        "ms_per_sweep": 1e3 * sweep_s / max(res.sweeps, 1),
        "achieved_gb_s": 4.0 * C2_M * C2_N * passes * res.sweeps
        / sweep_s / 1e9,
        "passes_per_sweep": passes,
        "f32_rel_gap": res.gaps.tolist(),
        "f64_rel_gap": f64,
        "nnz": (res.xs != 0).sum(dim=1).tolist(),
        "lambdas": np.asarray(res.lambdas.cpu()).tolist(),
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    return launches


def config2_cv(problem, gpu: str, power: str) -> None:
    """CV_K-fold CV over config 2's 10-point grid; the refit at the chosen
    lambda must reach the f32 floor in f64."""
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(**C2_CFG)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = cot.cv_lambda_path(problem, cfg, k=CV_K, path_len=C2_LEN, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(res.method_used == "bcd_batch", f"CV ran {res.method_used}")
    require(tuple(res.val_mse.shape) == (CV_K, C2_LEN)
            and bool(torch.isfinite(res.val_mse).all()), "CV val_mse")
    require(0 <= res.one_se_index <= res.best_index < C2_LEN,
            f"CV indices {res.best_index} {res.one_se_index}")
    for name in PATH_KERNELS + ("neg_at_r_t",):
        require(launches.get(name, 0) > 0, f"CV: {name} never launched")
    gap = float(cot.duality_gap(problem.with_lam1(res.best_lambda), res.x,
                                precise=True).rel_gap)
    require(gap <= C2_F32_FLOOR, f"CV refit f64 gap {gap}")
    print(json.dumps({
        "metric": f"config2_cv_{CV_K}fold_{C2_LEN}pt_{C2_M}x{C2_N}",
        "wall_s": wall,
        "fold_sweeps": list(res.fold_sweeps),
        "refit_sweeps": launches.get("batch_sweep_t", 0)
        - sum(res.fold_sweeps),
        "best_index": res.best_index,
        "best_lambda": res.best_lambda,
        "one_se_index": res.one_se_index,
        "one_se_lambda": res.one_se_lambda,
        "refit_f64_rel_gap": gap,
        "mean_mse": res.mean_mse.tolist(),
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)


def small_reference(device) -> None:
    """200 x 800: the solve on the card (kernels) against the same solve on
    the CPU (plain versions); both must certify after the polish."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    kw = dict(SOLVE_KW, block_size=40)
    inst_c, A, b = make_lasso_instance_host(0, 200, 800, device=device)
    inst_h, _, _ = make_lasso_instance_host(0, 200, 800)
    res_c = cot.solve(inst_c.problem, "bcd_pallas", **kw)
    res_h = cot.solve(inst_h.problem, "bcd_pallas", **kw)
    require(abs(res_c.iterations - res_h.iterations) <= kw["gap_every"],
            f"small solve sweeps {res_c.iterations} vs {res_h.iterations}")
    pr_c = cot.polish_support(inst_c.problem, res_c.x, tol=1e-6, A_host=A,
                              b_host=b)
    pr_h = cot.polish_support(inst_h.problem, res_h.x, tol=1e-6, A_host=A,
                              b_host=b)
    require(pr_c.rel_gap <= 1e-6 and pr_h.rel_gap <= 1e-6,
            f"small polish gaps {pr_c.rel_gap} {pr_h.rel_gap}")
    same = ((abs(pr_c.x) > 1e-4) == (abs(pr_h.x) > 1e-4)).all()
    require(bool(same), "small solve supports differ")
    log(f"# small reference 200x800: sweeps card={res_c.iterations} "
        f"cpu={res_h.iterations} rel_gap card={pr_c.rel_gap:.3e} "
        f"cpu={pr_h.rel_gap:.3e}")


def witness_bound_check(problem, x_pol, b_np) -> float:
    """|z32 - z64| <= gamma ||A_j|| ||r|| for every column at the polish
    residual; returns the largest ratio of error to bound."""
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.ops.matvec import (
        neg_at_r_t,
        witness_gamma,
    )

    dev = problem.device
    A_rows = problem.A_rows
    S = np.nonzero(x_pol)[0]
    xs = torch.as_tensor(x_pol[S], dtype=torch.float64, device=dev)
    r64 = (A_rows[torch.as_tensor(S, device=dev)].to(torch.float64).T @ xs
           - torch.as_tensor(b_np, dtype=torch.float64, device=dev))
    z32 = neg_at_r_t(problem.A_t, r64.to(torch.float32),
                     torch.zeros(problem.n, device=dev), 0.0)
    z64 = torch.empty(problem.n, dtype=torch.float64, device=dev)
    cn = torch.empty(problem.n, dtype=torch.float64, device=dev)
    for c0 in range(0, problem.n, 8192):
        blk = A_rows[c0:c0 + 8192].to(torch.float64)
        z64[c0:c0 + 8192] = -(blk @ r64)
        cn[c0:c0 + 8192] = torch.linalg.vector_norm(blk, dim=1)
    bound = witness_gamma(problem.m) * cn * torch.linalg.vector_norm(r64)
    ratio = float(((z32.to(torch.float64) - z64).abs() / bound).max())
    require(ratio <= 1.0, f"K3 witness bound violated (ratio {ratio})")
    return ratio


def main() -> None:
    t_start = time.perf_counter()
    # one card: the first, unless the caller picked one
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    count = torch.cuda.device_count()
    require(count == 1, f"needs exactly one visible card, sees {count}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.utils import native

    # 1. card and stack
    card = card_line()
    gpu_name, power_limit = [s.strip() for s in card.split(",", 1)]
    device = torch.device("cuda", 0)
    log(f"# card: {card}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. kernel build
    _build.load()
    build_s = _build.build_seconds
    log(f"# kernel build: {build_s:.2f} s ({len(_build.sources())} sources)")

    # 3. kernels vs plain versions
    stats: dict = {}
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    A_small = torch.randn(1024, 256, generator=gen).to(device)
    A_small /= torch.linalg.vector_norm(A_small, dim=1, keepdim=True)
    x_small = torch.randn(1024, generator=gen).to(device)
    b_small = torch.randn(256, generator=gen).to(device)
    keep_small = (torch.rand(1024, generator=gen) > 0.1).to(device)
    compare_kernels(A_small.view(32, 32, 256), b_small, x_small, keep_small,
                    "small", stats, timed=False)

    # the instance must be the JAX package's, and the polish its native path
    require(native.have_native(), "native host library did not build")
    native_lib = os.path.basename(native.library_path())
    t0 = time.perf_counter()
    inst, A_np, b_np = make_lasso_instance_host(SEED, M, N, device=device)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    problem = inst.problem
    log(f"# datagen {M}x{N}: {datagen_s:.2f} s, A_t {tuple(problem.A_t.shape)}"
        f", lam1 {float(problem.penalty.lam1):.6g}")
    A_t80 = problem.A_t.view(N // 80, 80, M)
    x_dense = torch.randn(N, generator=gen).to(device)
    keep_part = (torch.rand(64 * 80, generator=gen) > 0.1).to(device)
    compare_kernels(A_t80[:64], problem.b, x_dense[:64 * 80], keep_part,
                    "slice", stats, timed=False)
    compare_kernels(A_t80, problem.b, x_dense,
                    torch.ones(N, dtype=torch.bool, device=device), "full",
                    stats, timed=True)
    small_reference(device)

    # 4. main path
    torch.cuda.synchronize()
    _build.reset_launches()
    res = cot.solve(problem, method="bcd_pallas", **SOLVE_KW)
    pr = cot.polish_support(problem, res.x, tol=SOLVE_KW["tol"],
                            A_host=A_np, b_host=b_np, verbose=True)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"# solve: sweeps={res.iterations} f32 rel_gap={res.rel_gap:.3e} "
        f"wall={res.wall_time_s:.3f} s; polish: rel_gap={pr.rel_gap:.3e} "
        f"kept={pr.kept} sweeps={pr.iterations} wall={pr.wall_time_s:.3f} s"
        f"; launches {launches}")
    require(res.x.shape == (N,) and bool(torch.isfinite(res.x).all()),
            "solve returned a non-finite or misshapen x")
    require(pr.x.shape == (N,) and bool(np.isfinite(pr.x).all()),
            "polish returned a non-finite or misshapen x")
    require(pr.rel_gap <= SOLVE_KW["tol"],
            f"f64 certificate {pr.rel_gap} above {SOLVE_KW['tol']}")
    for name in MAIN_KERNELS:
        require(launches.get(name, 0) > 0, f"{name} never launched")
    ratio = witness_bound_check(problem, pr.x, b_np)
    log(f"# K3 witness bound at the polish residual: max err/bound "
        f"{ratio:.3e}")
    passes = 1.0 + 2.0 / SOLVE_KW["gap_every"]
    sweeps = res.iterations
    gb_s = 4.0 * M * N * passes * sweeps / res.wall_time_s / 1e9
    print(json.dumps({
        "metric": f"time_to_certified_1e-06_rel_gap_lasso_{M}x{N}",
        "sweeps": sweeps,
        "solve_wall_s": res.wall_time_s,
        "polish_wall_s": pr.wall_time_s,
        "total_s": res.wall_time_s + pr.wall_time_s,
        "ms_per_sweep": 1e3 * res.wall_time_s / max(sweeps, 1),
        "achieved_gb_s": gb_s,
        "passes_per_sweep": passes,
        "k4_setup_s": res.setup_time_s,
        "build_s": build_s,
        "datagen_s": datagen_s,
        "native_lib": native_lib,
        "nnz": int(np.count_nonzero(pr.x)),
        "f32_rel_gap": res.rel_gap,
        "f64_rel_gap": pr.rel_gap,
        "k3_bound_ratio": ratio,
        "gpu": gpu_name,
        "power_limit": power_limit,
    }), flush=True)
    del problem, inst, res, pr, A_np, b_np, A_t80

    # 5. batched kernels vs plain versions
    compare_batch_kernels(A_small.view(32, 32, 256), b_small, "small", stats,
                          timed=False)
    t0 = time.perf_counter()
    inst2, _, _ = make_lasso_instance_host(C2_SEED, C2_M, C2_N,
                                           device=device)
    torch.cuda.synchronize()
    log(f"# datagen {C2_M}x{C2_N}: {time.perf_counter() - t0:.2f} s")
    p2 = inst2.problem
    by_L = compare_batch_kernels(p2.with_block(80).A_t, p2.b, "config2",
                                 stats, timed=True)
    print(json.dumps({
        "metric": f"k5_ms_per_sweep_by_L_{C2_M}x{C2_N}_B80",
        "k5_ms": {str(k): v for k, v in by_L.items() if k != "k1"},
        "k1_ms": by_L["k1"],
        "k5_ms_per_point": {str(k): v / k for k, v in by_L.items()
                            if k != "k1"},
        "gpu": gpu_name, "power_limit": power_limit}), flush=True)

    # 6. small path reference, card against CPU
    small_path_reference(device)

    # 7. config 2: the lambda path, then K-fold CV
    path_launches = config2_path(p2, gpu_name, power_limit)
    config2_cv(p2, gpu_name, power_limit)

    require(all(math.isfinite(stats[k]["ms"]) for k in KERNELS),
            "kernel times")
    log(f"# chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    kernel_launches = {k: launches[k] for k in MAIN_KERNELS}
    kernel_launches.update({k: path_launches[k] for k in KERNELS
                            if k not in MAIN_KERNELS})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": kernel_launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
