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
     events (K2, K3 and K4 launched twice, torch.equal, and one JSON line
     of K2's and K3's times beside addmv and the bound; one of K4's beside
     matrix_norm, torch.bmm(A_t, A_t.mT) (the Gram alone) and the bounds
     of its Gram design and of its first design; one JSON line of K1's
     time, us per block and launch plan); K1 runs with a partly-zero
     keep mask at the small and slice shapes and with the main path's
     all-ones mask at full size; then a
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
     5000): K6 and K7 at L = 1, 4, 10, 16, each launched twice on the same
     inputs (torch.equal), timed on config 2's A_t beside addmm and the
     bound at each L (one JSON line per L); K5 at L = 10 unmasked as the
     lambda path calls it, with a partly-zero keep mask and a fold row
     mask as CV calls it, each launched twice (torch.equal), the masked K5
     against K5 on a masked copy of A_t (torch.equal), K5 at L = 1 against
     K1; K5 timed at L = 1, 4, 10, 16 (with us per block and its launch
     plan);
     K2 and K3 on config 2's A_t as in phase 3 (their JSON line);
  6. a 500 x 2000 10-point lambda path with bcd_batch and with bcd_pallas,
     on the card and on the CPU (plain versions): every converged point
     certifies in f64, supports agree between card and CPU;
  7. config 2 (5k x 50k, make_lasso_instance_host(0, ...)): the 10-point
     lambda_path(method="bcd_batch", tol=1e-6, max_iters=10000,
     gap_every=10, stall_checks=10, block_size=128), every point's f64
     rel_gap <= 1e-4 (the f32 floor of this configuration); the same path
     with lambda_path's default method, FISTA (K2 and K3 every step), each
     converged point certified the same, its wall beside bcd_batch's and
     K2's and K3's launches and share of its wall (launches times their
     phase-5 times); then
     3-fold cv_lambda_path on the same instance, its refit certified the
     same; the bcd_batch lines carry the checks' share of the wall (K6 and
     K7 launches times their phase-5 times at L = 10);
  8. config 4 (group lasso, 20k x 200k, 1000 groups of 200): K4 on the
     full A_t at B = 200 (G_j on chip) and B = 2000 (G in global memory)
     against its plain version, launched twice (torch.equal), timed (its
     JSON line as at the headline, without matrix_norm); group K1
     (B = 200) and K9 (B = 2000, a tile K1 cannot hold), and K5's group
     prox at L = 10 (B = 200, random weights, unmasked and with a keep
     mask and a fold row mask; the masked K5 against K5 on a masked copy,
     torch.equal, below 65 blocks) against their plain versions at a small
     shape, on a 16-block slice and on the full A_t, timed with CUDA
     events; a 4096 x 4000 group solve + polish on the card through both
     routes against the same on the CPU, and 3-fold group CV
     (refit=False) on the same instance on the card against the CPU; then
     two certified solves, solve(bcd_pallas, tol=1e-6, gap_every=10,
     stall_checks=15) with block_size=128 (B = 200: K1 + group prox) and
     block_size=3200 (B = 2000: K9), each polished by the group polish to
     an f64 rel_gap <= 1e-6; then the 10-point group lambda path
     (bcd_batch: K5's group prox, K6, K7) down to 0.1 lam_max, K5 launched
     once per sweep, every point's f64 rel_gap <= 1e-4, the last point
     polished to <= 1e-6;
  9. K8 (the column-sharded slab sweep, K1's payload instance) against
     its plain version: at a small shape with weighted group_l2 and a
     partly-zero mask and with nonneg_l1, on a 64-block slice of rank 0's
     slab of the headline at P = 2, and on that whole slab (625 x 80 x
     10000), timed beside K1 on the same slab (its JSON line with us per
     block); x, r, and the merge payload (dr and the three scalars) are
     compared, and K8's x and r must equal K1's bit for bit;
  10. the column-sharded path, SHARD_P = 2 spawned ranks sharing the card
     over gloo (the headline A reaches them as shared memory): psum, pmax,
     the broadcast and the all-gather exact on CUDA tensors, the ring and
     the reduce-scatter refused by the port on every rank with its own
     error; a 500 x 2000 sharded BCD and FISTA (l1) and BCD (weighted
     group_l2, 40 groups) on the card with psum and on the CPU in every
     mode, each certified after the polish with supports equal, and each
     card run held to the CPU run of the same input by path_check (the
     same primal path and rel_gap readings, the same crossings of 10 to
     10^4 x tol within one check, the last decade within two checks, a
     converged stop whose f64 gap before the polish is within 2 tol or
     twice the CPU's); the headline,
     solve(bcd_pallas, mesh=group, tol=1e-6, max_iters=20000,
     gap_every=10, stall_checks=15, block_size=128), x gathered and
     polished here to an f64 rel_gap <= 1e-6, K8 launched in every rank
     and K1 in none; then a world-size-1
     NCCL group against the single-device solve, and a 2000 x 10000
     single-device FISTA on the card against the CPU;
  11. config 3 (nonneg elastic net, lam2 1e-3, 10k x 100k): solve(
     bcd_pallas, ..., screen_every=1) with gap-safe screening at every
     check, some columns screened at the last check, polished to an f64
     rel_gap <= 1e-6;
  12. the working-set solvers at the headline: solve(fista_ws) and
     solve(bcd_ws) with phase 4's settings, each polished to an f64
     rel_gap <= 1e-6, K2 and K3 (and K1 and K4 for bcd_ws) launched, the
     last working set smaller than n; time to the certificate beside
     phase 4's;
  13. ADMM: solve(admm, admm_setup="host") at the headline (the Woodbury
     route: the 10000 x 10000 Gram on the card, its f64 eigh on the host)
     polished to an f64 rel_gap <= 1e-6, with the Gram's and the eigh's
     seconds; then the device set-up (an f32 eigh on the card) at 2000 x
     8000 on the card and on the CPU, both converged, certified after the
     polish, with the same support;
  14. config 2's 10-point grid with lambda_path(compact=True) and the
     bcd_ws, fista_ws and ADMM (admm_setup="host") paths, phase 7's
     settings, every converged point's f64 rel_gap <= 1e-4, beside phase
     7's walls;
  15. the group working set: solve(bcd_ws) on the small group reference
     instance (4096 x 4000, 40 groups) at 0.01 lam_max, on the card and on
     the CPU: the same rounds, working sets within one bucket, both
     polished to 1e-6 with the same active groups;
  16. the front door: polish (two f64 host passes) and polish_fast (K3's
     witness on the card) at phase 4's f32 x, each certified <= 1e-6 with
     phase 4's support, K3 launched; then cli.main in this process:
     config 3 at full width (bcd_pallas, --stall-checks 15, --polish,
     --checkpoint, --jsonl; K1-K4 launched, the JSONL's first record
     meta, the snapshot's f64 gap and the CLI's certificate <= 1e-6), the
     same resumed from the snapshot in fewer sweeps, config 2's FISTA
     path (every converged point's f64 gap <= 1e-4; K2, K3), config 1's
     3-fold CV (K5), config 4's CI twin (K2, K3) and config 5's CI twin
     over a world-size-1 NCCL group (K8 launched in the rank, K1 not).
  17. screening and the lambda paths on the column layout,
     SHARD_P spawned gloo ranks sharing the card as in phase 10: first
     K5, K6 and K7 against their plain versions on a 64-block slice of a
     rank's config-2 slab at the width the sharded batched path picks
     (B = 40); then in the ranks, on SHARD_SMALL (l1 and the weighted
     group_l2), the screened sharded BCD and the 5-point sharded
     bcd_pallas, fista and bcd_batch paths on the card and on the CPU,
     each card run held to the CPU run by path_check (every path point
     on its own); config 3 at full width through solve(bcd_pallas,
     mesh=group, screen_every=1), x gathered and polished here to an f64
     rel_gap <= 1e-6, its screened count beside phase 11's; config 2's
     10-point bcd_batch (K5-K7 on each rank's 625 x 40 x 5000 slab) and
     fista (K2, K3) paths with phase 7's settings, every converged point's
     f64 rel_gap <= 1e-4 and the largest |x - phase 7's x| reported.  The
     ranks' launches on the full-width runs are added to the kernels
     line.

Every path reads the launch counts set to 0 just before it.  Prints a JSON
line per measured phase, one for the kernels (each with its time, the
plain version's, a library call's where one PyTorch call computes the same
function, and its bound: the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s f32), the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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
CV_K = 3                     # cut from 5 folds for the run's time
BATCH_L = 10
MATVEC_LS = (1, 4, BATCH_L, 16)      # the L at which K6 and K7 are checked
# config 4: BASELINE.json:10, core/datagen.BENCH_CONFIGS["config4"]
C4_SOLVE = dict(tol=1e-6, max_iters=20_000, gap_every=10, stall_checks=15)
C4_ROUTES = (("k1_group", 128, 200, "sweep_t"),       # name, block_size, B,
             ("k9", 3200, 2000, "sweep_tiled_t"))     # the sweep it runs
# config 4's group lambda path: 10 points down to config 4's own lambda
# (0.1 lam_max), not 0.01: the depth is cut for the run's time
C4_PATH = dict(tol=1e-6, max_iters=2000, gap_every=10, stall_checks=10)
C4_PATH_LEN, C4_LAM_MIN = 10, 0.1
GROUP_B = 200                # config 4's K1 block (pick_block_size_t)
# K9 where the ring keeps most of a CTA's slab: 32 blocks of the tall
# shape (250 x 80 x 100 000, scripts/time_sweep.py tall_k9), 1 GB
TALL_K9 = (32, 80, 100_000)
# the small group CV, card against CPU: small_group_reference's instance
GROUP_CV = dict(tol=1e-5, max_iters=2000, gap_every=10, stall_checks=10)
GROUP_CV_LEN = 5
# config 3: BASELINE.json:9, the settings of scripts/measure_config3.py
C3_SEED, C3_LAM2 = 0, 1e-3
C3_SOLVE = dict(SOLVE_KW, screen_every=1)
# the column-sharded path (phase 10): SHARD_P gloo ranks share the one card
SHARD_P = 2
SHARD_SMALL = (1, 500, 2000)                           # seed, m, n
SHARD_GROUPS = 40          # the small run's weighted group_l2: 50 columns each
SHARD_BCD = dict(tol=1e-6, max_iters=20_000, gap_every=10, stall_checks=15,
                 block_size=128)
SHARD_FISTA = dict(tol=1e-5, max_iters=20_000, gap_every=10,
                   stall_checks=15)
# phase 17 on SHARD_SMALL, card against CPU: the screened sharded BCD and
# the sharded paths (5 points to 0.1 lam_max), each path point held to
# the CPU's by path_check.  The batched path at tol 1e-5: at 1e-6 its
# last decade reaches the f32 floor, where a one-ulp change of b alone
# moves a point's last decade by 3 checks (CPU ranks)
SHARD_SCREEN = dict(SHARD_BCD, screen_every=1)
SMALL_GRID = dict(path_len=5, lam_min_frac=0.1)
SMALL_PATHS = (("bcd_pallas", SHARD_BCD), ("fista", SHARD_FISTA),
               ("bcd_batch", dict(SHARD_BCD, tol=1e-5)))
# path_check: a small card run against the CPU run of the same input.  The
# primal objectives at every check agree to PATH_RTOL (one-ulp changes of
# b move them by 2e-7 on the CPU), and the f32 rel_gap readings, while the
# CPU's is >= PATH_LEVELS[0] x tol, to a factor of PATH_GAP_FACTOR; the
# first check at which the f32 rel_gap reaches each of PATH_LEVELS x tol
# is the CPU's to within one check; the checks from the first reading <=
# PATH_LEVELS[0] x tol to the stop (the last decade) are the CPU's to
# within PATH_LAST_DECADE.  The f32 reading is quantised at ~7e-8, so a
# crossing at tol itself is decided by rounding: one-ulp changes of b
# move the group_l2 run's last decade between 5 and 7 checks on the CPU
# and on the card (scripts/sharded_counts.py), and rounding-only changes
# of the sweep move the readings above 10 tol by up to 1.3x
# (tests/test_torch_path_check.py)
PATH_RTOL = 1e-5
PATH_GAP_FACTOR = 2.0
PATH_LEVELS = (10, 100, 1000, 10_000)
PATH_LAST_DECADE = 2
FISTA_MID = (2, 2000, 10_000)                          # seed, m, n
# ADMM at the headline: the JAX package's at-scale settings
# (scripts/measure_admm_scale.py:41-56); the device set-up card against
# CPU at a size under the fence (min(m, n) <= 4096), to an f32 tol of
# 1e-4: its f32 eigh floors the f32 gap at 2.3-2.6e-5 on the card and on
# the CPU alike, where tol 1e-5 ends both on the stall rule
ADMM_KW = dict(tol=1e-6, max_iters=4000, gap_every=10, stall_checks=25)
ADMM_SMALL = (6, 2000, 8000)                           # seed, m, n
ADMM_SMALL_KW = dict(tol=1e-4, max_iters=4000, gap_every=10,
                     stall_checks=25)
# the group working set: small_group_reference's instance at a lam1 where
# the burn-in does not reach tol, so a compact round runs (0.05 lam_max,
# that phase's, converges in the burn-in: no slab)
GROUP_WS_LAM = 0.01
# phase 16, the CLI: config 3 at full width as a user runs it (the CLI's
# default block size), then config 2's path with phase 7's stall rule
FRONT_C3 = ["--config", "config3", "--method", "bcd_pallas",
            "--stall-checks", "15", "--polish"]
FRONT_C2 = ["--config", "config2", "--stall-checks", "10"]
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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
    "sweep_tiled_t": (
        "convex_optimization_tpu_torch/csrc/sweep_tiled.cu",
        "convex_optimization_tpu/ops/bcd_sweep_pallas_tiled.py:94"),
    "sweep_slab_t": ("convex_optimization_tpu_torch/csrc/sweep.cu",
                     "convex_optimization_tpu/ops/bcd_sweep_pallas.py:126"),
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


def record(stats: dict, name: str, err: float, ms=None, plain_ms=None,
           library_ms=None, work=None) -> None:
    """Keep a kernel's largest error over every check, and its times at
    the timed shape with the work it does there: ``work`` = (bytes, flops),
    each input read once and each output written once."""
    s = stats.setdefault(name, {"max_abs_err": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    if ms is not None:
        s["ms"], s["plain_ms"], s["library_ms"] = ms, plain_ms, library_ms
        nbytes, flops = work
        by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        by_ops = 1e3 * flops / F32_FLOP_PER_S
        s["bound_ms"] = max(by_bytes, by_ops)
        s["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"


def sweep_work(m: int, n: int, n_blocks: int) -> tuple[int, int]:
    """(bytes, flops) of one sweep (K1 or K9): A once, x, r, the steps and
    the keep mask in, x and r out; two multiply-adds per element of A."""
    return 4 * m * n + 4 * (2 * n + 2 * m + n_blocks) + n, 4 * m * n


def tiled_design_work(m: int, n: int, n_blocks: int, chunk: int,
                      kept: int) -> tuple[int, int]:
    """(bytes, flops) that K9's plan must move from memory in one sweep:
    ``sweep_work``'s, plus A read again less what the ring keeps (the last
    ``kept`` chunks of ``chunk`` coordinates of each block: B - (N - kept)
    chunk coordinates, N = ceil(B / chunk)); L2 hits get no credit."""
    nbytes, flops = sweep_work(m, n, n_blocks)
    B = n // n_blocks
    kept_b = max(0, B - (-(-B // chunk) - kept) * chunk)
    return nbytes + 4 * m * n_blocks * (B - kept_b), flops


def compare_matvecs(A_t, b, x_probe, label: str, stats: dict, timed: bool,
                    card: tuple, main: bool = True) -> dict:
    """K2 and K3 against their plain versions on one A_t, each launched
    twice on the same inputs (the two results must be torch.equal); with
    ``timed``, one JSON line of their times beside the plain versions',
    the ``addmv`` computing the same function, and the bound.  Their
    largest errors go into ``stats``, and with ``main`` their times too
    (the kernels line's shape).  Returns {name: its record here}.

    Tolerances: K2 per row 1e-5 (||A[i, :]|| ||x|| + |b_i|), which bounds
    f32 rounding of a sum of n terms in any order (the limit must be able
    to reject a kernel that returned zeros); K3 its stated rounding bound
    witness_gamma(m) ||A_j|| ||r|| with ||A_j|| <= the largest column
    norm."""
    import torch

    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    n = nb * B
    zeros_n = torch.zeros(n, device=A_t.device)
    at: dict = {}

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
    require(torch.equal(r_k, mv.ax_minus_b_t(A_t, x_probe, b)),
            f"{label} ax_minus_b_t differs run to run")
    A = A_t.view(n, m).T
    times = (time_ms(lambda: mv.ax_minus_b_t(A_t, x_probe, b), 10),
             time_ms(lambda: mv.ax_minus_b_t_plain(A_t, x_probe, b), 10),
             time_ms(lambda: torch.addmv(b, A, x_probe, beta=-1.0), 10),
             (4 * m * n + 4 * n + 8 * m, 2 * m * n)) if timed else ()
    record(at, "ax_minus_b_t", err, *times)
    record(stats, "ax_minus_b_t", err, *(times if main else ()))

    z_k = mv.neg_at_r_t(A_t, r_p, zeros_n, 0.0)
    z_p = mv.neg_at_r_t_plain(A_t, r_p, zeros_n, 0.0)
    err = float((z_k - z_p).abs().max())
    col_max = float(torch.linalg.vector_norm(A_t, dim=2).max())
    bound = mv.witness_gamma(m) * col_max * float(
        torch.linalg.vector_norm(r_p))
    require(err <= bound, f"{label} neg_at_r_t err {err} > bound {bound}")
    require(torch.equal(z_k, mv.neg_at_r_t(A_t, r_p, zeros_n, 0.0)),
            f"{label} neg_at_r_t differs run to run")
    times = (time_ms(lambda: mv.neg_at_r_t(A_t, r_p, zeros_n, 0.0), 10),
             time_ms(lambda: mv.neg_at_r_t_plain(A_t, r_p, zeros_n, 0.0),
                     10),
             time_ms(lambda: torch.addmv(zeros_n, A.T, r_p, beta=0.0,
                                         alpha=-1.0), 10),
             (4 * m * n + 4 * m + 8 * n, 2 * m * n)) if timed else ()
    record(at, "neg_at_r_t", err, *times)
    record(stats, "neg_at_r_t", err, *(times if main else ()))
    if timed:
        print(json.dumps({
            "metric": f"k2_k3_ms_{label}_A_t_{nb}x{B}x{m}",
            "plan": vars(mv.matvec_plan(A_t.device, n, m)),
            "k2": at["ax_minus_b_t"], "k3": at["neg_at_r_t"],
            "k3_depth": mv.k3_depth(m),
            "gpu": card[0], "power_limit": card[1]}), flush=True)
    return at


def power_work(nb: int, B: int, m: int, iters: int = 48) -> dict:
    """K4's work at (nb, B, m) as (bytes, flops), each input read once and
    each output written once: the Gram design's (A once; the upper
    triangle of each G_j, B (B + 1) m flops a block, and iters + 1
    matvecs on G_j) and the first design's ((4 iters + 2) m n flops, and
    A read 2 iters + 1 times where a block does not fit the 50 MB L2)."""
    n = nb * B
    passes = 1 if 4 * B * m <= 50e6 else 2 * iters + 1
    return {"gram": (4 * m * n + 4 * nb,
                     B * (B + 1) * m * nb + 2 * (iters + 1) * B * B * nb),
            "first_design": (4 * m * n * passes + 4 * nb,
                             (4 * iters + 2) * m * n)}


def bound_ms(work) -> float:
    nbytes, flops = work
    return max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S)


def compare_power(A_t, label: str, stats: dict, timed: bool, card: tuple,
                  main: bool = False):
    """K4 against its plain version on one A_t, to 1e-4 relative per
    block (48 iterations), launched twice (torch.equal); with ``timed``,
    its time (CUDA events), the plain version's, ``torch.bmm(A_t,
    A_t.mT)`` (the Gram alone: the yardstick of K4's first phase, never
    called by the port) and both designs' bounds, in one JSON line; with
    ``main`` (the main path's A_t) also ``matrix_norm(A_t, ord=2)**2``,
    and the times go into ``stats`` (the kernels line).  Returns the plain
    estimates."""
    import torch

    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    L_k = mv.block_power_t(A_t)
    L_p = mv.block_power_t_plain(A_t)
    diff = (L_k - L_p).abs()
    err = float(diff.max())
    require(bool((diff <= 1e-4 * L_p.abs()).all()),
            f"{label} block_power_t err {err}, worst ratio "
            f"{float((diff / L_p.abs().clamp(min=1e-30)).max())}")
    require(torch.equal(L_k, mv.block_power_t(A_t)),
            f"{label} block_power_t differs run to run")
    record(stats, "block_power_t", err)
    if not timed:
        return L_p
    work = power_work(nb, B, m)
    ms = time_ms(lambda: mv.block_power_t(A_t), 3)
    plain_ms = time_ms(lambda: mv.block_power_t_plain(A_t), 1)
    lib_ms = (time_ms(lambda: torch.linalg.matrix_norm(A_t, ord=2) ** 2, 1)
              if main else None)
    if main:
        record(stats, "block_power_t", err, ms, plain_ms, lib_ms,
               work["gram"])
    print(json.dumps({
        "metric": f"k4_ms_{label}_A_t_{nb}x{B}x{m}",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bmm_ms": time_ms(lambda: torch.bmm(A_t, A_t.mT), 1),
        "bound_ms": bound_ms(work["gram"]),
        "first_design_bound_ms": bound_ms(work["first_design"]),
        "max_abs_err": err, "max_rel_err": float((diff / L_p.abs().clamp(
            min=1e-30)).max()),
        "plan": dataclasses.asdict(mv.power_tiling(
            nb, B, m, torch.cuda.get_device_properties(
                A_t.device).multi_processor_count)),
        "gpu": card[0], "power_limit": card[1]}), flush=True)
    return L_p


def compare_kernels(A_t, b, x_probe, keep, label: str, stats: dict,
                    timed: bool, card: tuple) -> None:
    """Every kernel against its plain version on one A_t; ``x_probe`` is
    a dense vector, ``keep`` K1's keep mask.

    Tolerances: f32 sums in another order than the plain versions', so
    one pass over A agrees to rounding (relative tol on the scale of the
    result; K2 and K3 as ``compare_matvecs``); K1 chains n_blocks
    dependent updates, so the full-size sweep gets 1e-4 where a slice gets
    1e-5; K4 gets 1e-4 (48 iterations)."""
    import torch

    from convex_optimization_tpu_torch.models.penalties import l1
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    zeros_n = torch.zeros(nb * B, device=A_t.device)

    L_p = compare_power(A_t, label, stats, timed, card, main=True)
    n = nb * B

    compare_matvecs(A_t, b, x_probe, label, stats, timed, card)

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
                                              pen, 0.0), 2),
             None, sweep_work(m, n, nb)) if timed else ()
    record(stats, "sweep_t", max(ex, float((rk - rp).abs().max())), *times)
    if timed:
        st = stats["sweep_t"]
        print(json.dumps({
            "metric": f"k1_sweep_ms_{label}_A_t_{nb}x{B}x{m}",
            "ms": st["ms"], "us_per_block": 1e3 * st["ms"] / nb,
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "plan": k1_plan(A_t.device, B, m),
            "gpu": card[0], "power_limit": card[1]}), flush=True)
    torch.cuda.synchronize()
    log(f"# kernels vs plain [{label}] A_t={tuple(A_t.shape)}: ok")


def k1_plan(device, B: int, m: int) -> dict:
    """K1's launch plan at (B, m), as a JSON line shows it."""
    import dataclasses

    from convex_optimization_tpu_torch.ops import bcd_sweep as k1

    plan = k1.sweep_plan(device, B, m)
    return dataclasses.asdict(plan) | {"smem_bytes": plan.smem_bytes}


def k9_plan(device, B: int, m: int) -> dict:
    """K9's launch plan at (B, m), as a JSON line shows it."""
    import dataclasses

    from convex_optimization_tpu_torch.ops import bcd_sweep_tiled as k9

    plan = k9.tiled_plan(device, B, m)
    return dataclasses.asdict(plan) | {"n_chunks": plan.n_chunks,
                                       "smem_bytes": plan.smem_bytes}


def k9_bounds(m: int, n: int, nb: int, plan: dict | None,
              extra: int = 0) -> dict:
    """K9's bounds at one shape, in ms at 3.35 TB/s: A read once (the
    kernels line's bound), A read twice (the first design's reads) and,
    given a ``plan``, its design bound (``tiled_design_work``); ``extra``
    bytes (the group weights) on each."""
    one = sweep_work(m, n, nb)[0] + extra
    out = {"bound_ms": 1e3 * one / HBM_BYTES_PER_S,
           "two_reads_ms": 1e3 * (one + 4 * m * n) / HBM_BYTES_PER_S}
    if plan is not None:
        design = tiled_design_work(m, n, nb, plan["chunk"], plan["kept"])[0]
        out["design_bound_ms"] = 1e3 * (design + extra) / HBM_BYTES_PER_S
    return out


def compare_batch_matvecs(A_t, b, L: int, label: str, stats: dict, gen,
                          timed: bool, card: tuple) -> None:
    """K6 and K7 against their plain versions at one L, each launched
    twice on the same inputs (the two results must be torch.equal); with
    ``timed``, one JSON line of their times beside the plain versions',
    the ``addmm`` computing the same function, and the bound at this L.

    Tolerances: one pass over A in another summation order, per element
    1e-5 (||A[i, :]|| ||x_l|| + |b_i|) for K6 and 1e-5 (||A_k|| ||r_l||
    + lam2 |x|) for K7."""
    import torch

    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb

    nb, B, m = A_t.shape
    n, dev, lam2 = nb * B, A_t.device, 0.1
    X = torch.randn(nb, L, B, generator=gen).to(dev)

    R_k = kb.ax_minus_b_batch_t(A_t, X, b)
    R_p = kb.ax_minus_b_batch_t_plain(A_t, X, b)
    row = torch.linalg.vector_norm(A_t, dim=(0, 1))
    xn = torch.linalg.vector_norm(kb.rows_of(X), dim=1)
    tol = 1e-5 * (xn[:, None] * row[None, :] + b.abs()[None, :])
    diff = (R_k - R_p).abs()
    require(bool((diff <= tol).all()),
            f"{label} L={L} ax_minus_b_batch_t worst ratio "
            f"{float((diff / tol).max())}")
    require(bool((R_p.abs() > tol).any()),
            f"{label} L={L} ax_minus_b_batch_t limit cannot tell R from 0")
    require(torch.equal(R_k, kb.ax_minus_b_batch_t(A_t, X, b)),
            f"{label} L={L} ax_minus_b_batch_t differs run to run")
    err6 = float(diff.max())

    Z_k = kb.neg_at_r_batch_t(A_t, R_p, X, lam2)
    Z_p = kb.neg_at_r_batch_t_plain(A_t, R_p, X, lam2)
    col = torch.linalg.vector_norm(A_t, dim=2)
    rn = torch.linalg.vector_norm(R_p, dim=1)
    tolz = 1e-5 * (col[:, None, :] * rn[None, :, None] + lam2 * X.abs())
    diff = (Z_k - Z_p).abs()
    require(bool((diff <= tolz).all()),
            f"{label} L={L} neg_at_r_batch_t worst ratio "
            f"{float((diff / tolz).max())}")
    require(torch.equal(Z_k, kb.neg_at_r_batch_t(A_t, R_p, X, lam2)),
            f"{label} L={L} neg_at_r_batch_t differs run to run")
    err7 = float(diff.max())
    if not timed:
        record(stats, "ax_minus_b_batch_t", err6)
        record(stats, "neg_at_r_batch_t", err7)
        return

    A_rows, X_rows = A_t.view(n, m), kb.rows_of(X).contiguous()
    S, W, C, G = kb.matvec_batch_plan(dev, n, m, L)
    k6 = (time_ms(lambda: kb.ax_minus_b_batch_t(A_t, X, b), 10),
          time_ms(lambda: kb.ax_minus_b_batch_t_plain(A_t, X, b), 10),
          time_ms(lambda: torch.addmm(b, X_rows, A_rows, beta=-1.0), 10),
          (4 * m * n + 4 * L * n + 4 * m + 4 * L * m, 2 * m * n * L))
    k7 = (time_ms(lambda: kb.neg_at_r_batch_t(A_t, R_p, X, lam2), 10),
          time_ms(lambda: kb.neg_at_r_batch_t_plain(A_t, R_p, X, lam2), 10),
          time_ms(lambda: torch.addmm(X_rows, R_p, A_rows.T, beta=-lam2,
                                      alpha=-1.0), 10),
          (4 * m * n + 4 * L * m + 8 * L * n, 2 * m * n * L))
    at_L: dict = {}
    record(at_L, "k6", err6, *k6)
    record(at_L, "k7", err7, *k7)
    if L == BATCH_L:
        record(stats, "ax_minus_b_batch_t", err6, *k6)
        record(stats, "neg_at_r_batch_t", err7, *k7)
    # the partials each kernel writes and reads back (not in the bound:
    # they are not inputs or outputs of the function)
    at_L["k6"]["partials_bytes"] = 2 * 4 * S * L * m
    at_L["k7"]["partials_bytes"] = 2 * 4 * C * n * L if C > 1 else 0
    print(json.dumps({
        "metric": f"k6_k7_ms_{label}_L{L}_A_t_{nb}x{B}x{m}",
        "L": L, "plan": dict(k6_slices=S, k7_chunk=W, k7_chunks=C,
                             k7_ctas_per_chunk=G),
        "k6": at_L["k6"], "k7": at_L["k7"],
        "gpu": card[0], "power_limit": card[1]}), flush=True)


def sweep_err(label: str, what: str, xk, rk, xp, rp, tol: float) -> float:
    """One sweep against its plain version: x to ``tol`` of max(1, |x|),
    r to ``tol`` of ||r|| (relative); returns the largest difference."""
    import torch

    ex = float((xk - xp).abs().max())
    er = float(torch.linalg.vector_norm(rk - rp))
    require(ex <= tol * max(1.0, float(xp.abs().max())),
            f"{label} {what} x err {ex} (tol {tol})")
    require(er <= tol * float(torch.linalg.vector_norm(rp)),
            f"{label} {what} r err {er} (tol {tol})")
    return max(ex, float((rk - rp).abs().max()))


def check_k5(A_t, b, lam1s, steps, pen, keep, rm, label: str,
             masked_copy: bool) -> float:
    """K5 against its plain version from X = 0, R = -b (as a path starts):
    unmasked as the lambda path calls it, and with the keep mask ``keep``
    and the fold row mask ``rm`` as CV calls it; with ``masked_copy`` the
    masked sweep against the sweep on a masked copy of A_t, bit for bit.
    Tolerance as K1's (1e-5, 1e-4 past 64 blocks); two launches on the
    same inputs must give the same bits.  Returns the largest difference."""
    import torch

    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb

    nb, B, m = A_t.shape
    L = lam1s.shape[0]
    tol = 1e-4 if nb > 64 else 1e-5
    X0 = torch.zeros(nb, L, B, device=A_t.device)
    R0 = (-b)[None, :].expand(L, m).contiguous()
    R0m = (-(rm * b))[None, :].expand(L, m).contiguous()
    what = f"batch_sweep_t {pen.kind}"
    err = 0.0
    for how, R_in, masks in (("unmasked", R0, (None, None)),
                             ("masked", R0m, (keep, rm))):
        args = (A_t, X0, R_in, steps, lam1s, 0.0, pen) + masks
        Xk, Rk = kb.batch_sweep_t(*args)
        Xr, Rr = kb.batch_sweep_t(*args)
        require(torch.equal(Xk, Xr) and torch.equal(Rk, Rr),
                f"{label} {what} {how}: two launches differ")
        Xp, Rp = kb.batch_sweep_t_plain(*args)
        require(float(Xp.abs().max()) > 0, f"{label} {what} {how}: X is 0")
        err = max(err, sweep_err(label, f"{what} {how}", Xk, Rk, Xp, Rp,
                                 tol))
    require(bool((kb.rows_of(Xk)[:, ~keep] == 0).all()),
            f"{label} {what} kept a masked x")
    if masked_copy:
        A_copy = A_t * rm
        X1, R1 = kb.batch_sweep_t(A_copy, X0, R0m, steps, lam1s, 0.0, pen,
                                  keep)
        X2, R2 = Xk, Rk
        for _ in range(2):
            X1, R1 = kb.batch_sweep_t(A_copy, X1, R1, steps, lam1s, 0.0, pen,
                                      keep)
            X2, R2 = kb.batch_sweep_t(A_t, X2, R2, steps, lam1s, 0.0, pen,
                                      keep, rm)
        require(torch.equal(X1, X2) and torch.equal(R1, R2),
                f"{label} masked {what} differs from the masked copy")
    return err


def k5_plan(device, B: int, m: int, L: int, gsize: int = 0) -> dict:
    """K5's launch plan at (B, m, L, gsize), as a JSON line shows it."""
    import dataclasses

    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb

    plan = kb.batch_plan(device, B, m, L, gsize)
    return dataclasses.asdict(plan) | {"smem_bytes": plan.smem_bytes}


def compare_batch_kernels(A_t, b, label: str, stats: dict, timed: bool,
                          card: tuple) -> dict:
    """K6 and K7 at L = 1, 4, 10, 16 (compare_batch_matvecs), then K5
    against its plain version at L = BATCH_L; returns K5's ms per sweep by
    L (empty unless ``timed``).

    Tolerances: K5 as K1 (1e-5, 1e-4 past 64 blocks); the masked K5 equals
    K5 on a masked copy of A_t exactly."""
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.models.penalties import l1
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    n, L, dev = nb * B, BATCH_L, A_t.device
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    for Lm in MATVEC_LS:
        compare_batch_matvecs(A_t, b, Lm, label, stats, gen, timed, card)

    # K5 from X = 0, R = -b (as a path starts), l1 on a geometric grid
    zeros_n = torch.zeros(n, device=dev)
    lmax = float(mv.neg_at_r_t_plain(A_t, b, zeros_n, 0.0).abs().max())
    lam1s = torch.as_tensor(np.geomspace(0.95, 0.01, L) * lmax,
                            dtype=torch.float32, device=dev)
    steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
    pen = l1(1.0)
    keep = (torch.rand(n, generator=gen) > 0.1).to(dev)
    rm = (torch.rand(m, generator=gen) > 0.2).to(torch.float32).to(dev)
    err = check_k5(A_t, b, lam1s, steps, pen, keep, rm, label, True)
    X0 = torch.zeros(nb, L, B, device=dev)
    R0 = (-b)[None, :].expand(L, m).contiguous()
    # L = 1 against K1 on the same inputs
    X5, R5 = kb.batch_sweep_t(A_t, X0[:, :1].contiguous(), R0[:1].contiguous(),
                              steps, lam1s[:1].contiguous(), 0.0, pen, keep)
    x1, r1 = k1.sweep_t(A_t, zeros_n, -b, steps, keep, l1(float(lam1s[0])),
                        0.0)
    err = max(err, sweep_err(label, "batch_sweep_t L=1 vs K1",
                             X5[:, 0].reshape(n), R5[0], x1, r1,
                             1e-4 if nb > 64 else 1e-5))
    by_L = {}
    times = ()
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
                     A_t, X0, R0, steps, lam1s, 0.0, pen), 1), None,
                 (4 * m * n + 4 * L * (2 * n + 2 * m) + 4 * (L + nb),
                  4 * m * n * L))
    record(stats, "batch_sweep_t", err, *times)
    torch.cuda.synchronize()
    log(f"# batched kernels vs plain [{label}] A_t={tuple(A_t.shape)} "
        f"L={L}: ok")
    return by_L


def compare_group_batch(A_rows, b, gsize: int, weights, B: int, label: str,
                        stats: dict, timed: bool, card: tuple) -> None:
    """K5's group prox (group_l2 over groups of ``gsize`` with
    ``weights``) against its plain version at L = BATCH_L on one (n, m)
    A_rows in blocks of B, from X = 0, R = -b on a grid from 0.95 to 0.1
    of the group lam_max: unmasked as the lambda path calls it, and with a
    partly-zero keep mask and a fold row mask as CV calls it; below 65
    blocks the masked sweep against the sweep on a masked copy of A_t
    (torch.equal).  With ``timed``, one JSON line of its time beside the
    plain version's and the bound.  Tolerances as K5's (1e-5, 1e-4 past
    64 blocks)."""
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.models.penalties import group_l2, l1
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_batch as kb
    from convex_optimization_tpu_torch.ops import matvec as mv

    n, m = A_rows.shape
    nb, L, ng, dev = n // B, BATCH_L, n // gsize, A_rows.device
    A_t = A_rows.view(nb, B, m)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    z = mv.neg_at_r_t_plain(A_t, b, torch.zeros(n, device=dev), 0.0)
    lmax = float((torch.linalg.vector_norm(z.view(ng, gsize), dim=1)
                  / weights).max())
    lam1s = torch.as_tensor(np.geomspace(0.95, 0.1, L) * lmax,
                            dtype=torch.float32, device=dev)
    steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
    pen = group_l2(1.0, ng, weights)
    keep = (torch.rand(n, generator=gen) > 0.1).to(dev)
    rm = (torch.rand(m, generator=gen) > 0.2).to(torch.float32).to(dev)
    err = check_k5(A_t, b, lam1s, steps, pen, keep, rm, label, nb <= 64)
    record(stats, "batch_sweep_t", err)
    if timed:
        X0 = torch.zeros(nb, L, B, device=dev)
        R0 = (-b)[None, :].expand(L, m).contiguous()
        at: dict = {}
        record(at, "k5", err,
               time_ms(lambda: kb.batch_sweep_t(A_t, X0, R0, steps, lam1s,
                                                0.0, pen), 5),
               time_ms(lambda: kb.batch_sweep_t_plain(
                   A_t, X0, R0, steps, lam1s, 0.0, pen), 1), None,
               (4 * m * n + 4 * L * (2 * n + 2 * m) + 4 * (L + nb + ng),
                4 * m * n * L))
        # K5 with the l1 prox on the same tile: what the group branch adds
        l1_ms = time_ms(lambda: kb.batch_sweep_t(A_t, X0, R0, steps, lam1s,
                                                 0.0, l1(1.0)), 5)
        print(json.dumps({
            "metric": f"k5_group_ms_{label}_A_t_{nb}x{B}x{m}",
            "L": L, "gsize": gsize, "k5_group": at["k5"],
            "k5_us_per_block": 1e3 * at["k5"]["ms"] / nb,
            "k5_plan": k5_plan(dev, B, m, L, gsize),
            "k5_l1_ms_same_tile": l1_ms,
            "gpu": card[0], "power_limit": card[1]}), flush=True)
    torch.cuda.synchronize()
    log(f"# group K5 vs plain [{label}] A_t={tuple(A_t.shape)} gsize="
        f"{gsize} L={L}: ok (max err {err:.3e})")


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
    inst_h, _, _ = make_lasso_instance_host(1, 500, 2000, device="cpu")
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


def checks_s(launches: dict, stats: dict) -> float:
    """Seconds of K6 and K7 in a run: launches times their timed ms."""
    return sum(launches.get(k, 0) * stats[k]["ms"]
               for k in ("ax_minus_b_batch_t", "neg_at_r_batch_t")) / 1e3


def config2_path(problem, gpu: str, power: str, stats: dict
                 ) -> tuple[dict, float, dict]:
    """Config 2's 10-point bcd_batch lambda path; every point's f64
    rel_gap must reach the f32 floor.  Returns the launch counts, the
    wall and the path's xs (on the CPU), sweeps and wall for phase 17."""
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
        "returned_rel_gap": res.gaps.tolist(),
        "f64_rel_gap": f64,
        "nnz": (res.xs != 0).sum(dim=1).tolist(),
        "lambdas": np.asarray(res.lambdas.cpu()).tolist(),
        "launches": launches,
        "checks_share": checks_s(launches, stats) / wall,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    require(max(f64) <= C2_F32_FLOOR, f"config-2 f64 gaps {f64}")
    return launches, wall, dict(xs=res.xs.cpu(), sweeps=res.sweeps,
                                wall=wall)


def config2_fista_path(problem, gpu: str, power: str, bcd_wall: float,
                       matvec: dict) -> dict:
    """Config 2's 10-point FISTA lambda path (lambda_path's default
    method) with the bcd_batch path's settings: K2 and K3 launched on
    every step, every converged point's f64 rel_gap at the f32 floor; its
    wall beside the bcd_batch path's, and K2's and K3's launches and their
    share of the wall (launches times their phase-5 time on config 2's
    A_t, ``matvec``, over the wall).  Returns the wall, and the path's
    xs (on the CPU) and steps for phase 17."""
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    cfg = SolverConfig(**C2_CFG)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = cot.lambda_path(problem, cfg, path_len=C2_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(res.method_used == "fista", f"FISTA path ran {res.method_used}")
    for name in ("ax_minus_b_t", "neg_at_r_t"):
        require(launches.get(name, 0) > res.sweeps > 0,
                f"FISTA path: {name} launches {launches.get(name, 0)} for "
                f"{res.sweeps} steps")
    require(res.xs.shape == (C2_LEN, C2_N)
            and bool(torch.isfinite(res.xs).all()), "FISTA path x")
    f64 = certify(problem, res, cfg.tol)
    conv = res.converged.cpu().tolist()
    print(json.dumps({
        "metric": f"config2_lambda_path_{C2_LEN}pt_fista_{C2_M}x{C2_N}",
        "steps": res.sweeps,
        "iters": res.iters.tolist(),
        "wall_s": wall,
        "ms_per_step": 1e3 * wall / max(res.sweeps, 1),
        "bcd_batch_wall_s": bcd_wall,
        "k2_launches": launches["ax_minus_b_t"],
        "k3_launches": launches["neg_at_r_t"],
        "k2_share": launches["ax_minus_b_t"]
        * matvec["ax_minus_b_t"]["ms"] / 1e3 / wall,
        "k3_share": launches["neg_at_r_t"]
        * matvec["neg_at_r_t"]["ms"] / 1e3 / wall,
        "converged": conv,
        "f32_rel_gap": res.gaps.tolist(),
        "f64_rel_gap": f64,
        "nnz": (res.xs != 0).sum(dim=1).tolist(),
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    bad = [g for g, c in zip(f64, conv) if c and g > C2_F32_FLOOR]
    require(not bad, f"FISTA path: converged points with f64 gaps {bad}")
    return dict(xs=res.xs.cpu(), sweeps=res.sweeps, wall=wall)


def config2_cv(problem, gpu: str, power: str, stats: dict) -> None:
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
        "checks_share": checks_s(launches, stats) / wall,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)


def compare_group_sweeps(A_rows, b, lam1: float, gsize: int, weights,
                         keep, widths: dict, label: str, stats: dict,
                         timed: bool) -> dict:
    """Group K1 and K9 against their plain versions on one (n, m) A_rows,
    each at its own block width (``widths``: kernel name -> B): one sweep
    from x = 0, r = -b with group_l2 over groups of ``gsize``, launched
    twice (torch.equal).  Tolerances as K1's (1e-5, 1e-4 past 64 blocks).
    Returns each kernel's and plain version's ms and bound when ``timed``
    (K9's with its plan, its two-read time and its design bound)."""
    import torch

    from convex_optimization_tpu_torch.models.penalties import group_l2
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_tiled as k9
    from convex_optimization_tpu_torch.ops import matvec as mv

    n, m = A_rows.shape
    pen = group_l2(lam1, n // gsize, weights)
    zeros_n = torch.zeros(n, device=A_rows.device)
    out, checked = {}, {}
    for name, B in widths.items():
        kernel, plain = {"sweep_t": (k1.sweep_t, k1.sweep_t_plain),
                         "sweep_tiled_t": (k9.sweep_tiled_t,
                                           k9.sweep_tiled_t_plain)}[name]
        A_t = A_rows.view(n // B, B, m)
        nb = n // B
        steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
        args = (A_t, zeros_n, -b, steps, keep, pen, 0.0)
        xk, rk = kernel(*args)
        xk2, rk2 = kernel(*args)
        require(torch.equal(xk, xk2) and torch.equal(rk, rk2),
                f"{label} {name} differs run to run")
        del xk2, rk2
        xp, rp = plain(*args)
        tol = 1e-4 if nb > 64 else 1e-5
        ex = float((xk - xp).abs().max())
        er = float(torch.linalg.vector_norm(rk - rp))
        require(float(xp.abs().max()) > 0, f"{label} {name}: x stayed 0")
        require(ex <= tol * max(1.0, float(xp.abs().max())),
                f"{label} {name} group x err {ex} (tol {tol})")
        require(er <= tol * float(torch.linalg.vector_norm(rp)),
                f"{label} {name} group r err {er} (tol {tol})")
        if keep is not None:
            require(bool((xk[~keep] == 0).all()),
                    f"{label} {name} kept a masked x")
        err = max(ex, float((rk - rp).abs().max()))
        record(stats, name, err)
        checked[name] = f"B={B} max_abs_err={err:.3e} tol={tol:g} (relative)"
        if timed:
            out[name] = dict(
                B=B, ms=time_ms(lambda: kernel(*args), 5),
                plain_ms=time_ms(lambda: plain(*args), 1),
                work=sweep_work(m, n, nb), max_abs_err=err, tol=tol)
            out[name]["us_per_block"] = 1e3 * out[name]["ms"] / nb
            if name == "sweep_t":
                out[name]["plan"] = k1_plan(A_rows.device, B, m)
            else:
                plan = k9_plan(A_rows.device, B, m)
                out[name]["plan"] = plan
                out[name] |= k9_bounds(m, n, nb, plan)
    torch.cuda.synchronize()
    log(f"# group sweeps vs plain [{label}] n={n} m={m}: ok {checked}")
    return out


def compare_tall_k9(device, stats: dict, gpu: str, power: str) -> None:
    """K9 where the ring keeps most of a CTA's slab: a TALL_K9 slice of the
    tall shape (B = 80, m = 100 000: 243 KB a CTA, 1 GB in all), random
    unit columns, l1 at 0.1 lam_max with a partly-zero keep mask, one sweep
    from the plain version's first sweep from x = 0 (so x and dx are both
    nonzero), launched twice (torch.equal) and held to the plain version
    as K1 is after one sweep (x to 1e-5 of max(1, |x|), r to 1e-5 of ||r||);
    timed, with its plan and bounds (one JSON line)."""
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_tiled as k9
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = TALL_K9
    n = nb * B
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    A_t = torch.randn(nb, B, m, generator=gen, device=device)
    A_t /= torch.linalg.vector_norm(A_t, dim=2, keepdim=True)
    b = torch.randn(m, generator=gen, device=device)
    zeros_n = torch.zeros(n, device=device)
    pen = cot.l1(0.1 * float(mv.neg_at_r_t_plain(A_t, b, zeros_n, 0.0)
                             .abs().max()))
    keep = torch.rand(n, generator=gen, device=device) > 0.1
    steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
    x0, r0 = k9.sweep_tiled_t_plain(A_t, zeros_n, -b, steps, keep, pen, 0.0)
    args = (A_t, x0, r0, steps, keep, pen, 0.0)
    xk, rk = k9.sweep_tiled_t(*args)
    xk2, rk2 = k9.sweep_tiled_t(*args)
    require(torch.equal(xk, xk2) and torch.equal(rk, rk2),
            "tall K9 differs run to run")
    xp, rp = k9.sweep_tiled_t_plain(*args)
    require(float((xp - x0).abs().max()) > 0, "tall K9: x did not move")
    err = sweep_err("tall", "sweep_tiled_t", xk, rk, xp, rp, 1e-5)
    require(bool((xk[~keep] == 0).all()), "tall K9 kept a masked x")
    record(stats, "sweep_tiled_t", err)
    ms = time_ms(lambda: k9.sweep_tiled_t(*args), 10)
    plan = k9_plan(device, B, m)
    print(json.dumps({
        "metric": f"k9_tall_sweep_ms_A_t_{nb}x{B}x{m}", "ms": ms,
        "us_per_block": 1e3 * ms / nb,
        "plain_ms": time_ms(lambda: k9.sweep_tiled_t_plain(*args), 1),
        **k9_bounds(m, n, nb, plan), "max_abs_err": err, "tol": 1e-5,
        "plan": plan, "gpu": gpu, "power_limit": power}), flush=True)
    del A_t
    torch.cuda.empty_cache()


def small_group_reference(device) -> None:
    """4096 x 4000 group lasso (40 groups of 100, lam1 at 0.05 lam_max),
    solved on the card through K1 (block_size 200) and K9 (block_size
    2000) and on the CPU (plain versions) to an f32 rel_gap of 1e-5, each
    polished: all certify 1e-6 in f64, the active groups agree, the sweep
    counts agree within one check.  (At an f32 tol of 1e-6 the card, whose
    K3 sums in f32, can sit just above it and end on the stall rule where
    the CPU's f64-summed plain K3 does not: a floor, not a fault.)"""
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build

    kw = dict(penalty_kind="group_l2", ngroups=40, lam1_frac=0.05)
    inst_c, A, b = make_lasso_instance_host(4, 4096, 4000, device=device,
                                            **kw)
    inst_h, _, _ = make_lasso_instance_host(4, 4096, 4000, device="cpu",
                                            **kw)
    out = {}
    for bs, kernel in ((200, "sweep_t"), (2000, "sweep_tiled_t")):
        _build.reset_launches()
        solve_kw = dict(C4_SOLVE, block_size=bs, tol=1e-5)
        res_c = cot.solve(inst_c.problem, "bcd_pallas", **solve_kw)
        require(_build.launches[kernel] == res_c.iterations > 0,
                f"small group solve B={bs} did not run {kernel}")
        res_h = cot.solve(inst_h.problem, "bcd_pallas", **solve_kw)
        require(abs(res_c.iterations - res_h.iterations)
                <= C4_SOLVE["gap_every"],
                f"small group B={bs} sweeps {res_c.iterations} vs "
                f"{res_h.iterations} (f32 rel_gap {res_c.rel_gap:.3e} vs "
                f"{res_h.rel_gap:.3e})")
        pr_c = cot.polish_support(inst_c.problem, res_c.x, tol=1e-6,
                                  A_host=A, b_host=b)
        pr_h = cot.polish_support(inst_h.problem, res_h.x, tol=1e-6,
                                  A_host=A, b_host=b)
        require(pr_c.rel_gap <= 1e-6 and pr_h.rel_gap <= 1e-6,
                f"small group polish gaps {pr_c.rel_gap} {pr_h.rel_gap}")
        act_c = np.abs(pr_c.x).reshape(40, -1).sum(axis=1) > 0
        act_h = np.abs(pr_h.x).reshape(40, -1).sum(axis=1) > 0
        require(bool((act_c == act_h).all()), "small group supports differ")
        out[kernel] = dict(card_sweeps=res_c.iterations,
                           cpu_sweeps=res_h.iterations,
                           f32_card=res_c.rel_gap, f32_cpu=res_h.rel_gap,
                           groups=int(act_c.sum()),
                           rel_gap_card=pr_c.rel_gap,
                           rel_gap_cpu=pr_h.rel_gap)
    log(f"# small group reference 4096x4000: {out}")


def small_group_cv(device) -> None:
    """The same 4096 x 4000 group lasso (B = 200, two groups a block):
    3-fold CV over a 5-point grid without the refit, through K5's group
    prox, K6 and K7 on the card and their plain versions on the CPU: both
    run bcd_batch, pick the same lambda, and agree on the validation MSE to
    rtol 1e-3 (f32 paths that end on the same tolerance)."""
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    kw = dict(penalty_kind="group_l2", ngroups=40, lam1_frac=0.05)
    cfg = SolverConfig(**GROUP_CV)
    runs = []
    for dev in (device, "cpu"):
        inst, _, _ = make_lasso_instance_host(4, 4096, 4000, device=dev, **kw)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = cot.cv_lambda_path(inst.problem, cfg, k=3, path_len=GROUP_CV_LEN,
                                 refit=False)
        runs.append((res, dict(_build.launches), time.perf_counter() - t0))
    (rc, lc, wc), (rh, lh, wh) = runs
    require(rc.method_used == rh.method_used == "bcd_batch",
            f"small group CV ran {rc.method_used} / {rh.method_used}")
    require(lc.get("batch_sweep_t", 0) == sum(rc.fold_sweeps) > 0
            and sum(lh.values()) == 0,
            f"small group CV launches card {lc}, CPU {lh}")
    require(rc.x is None and rh.x is None, "small group CV refit ran")
    require(rc.best_index == rh.best_index,
            f"small group CV best index {rc.best_index} vs {rh.best_index}")
    vc, vh = rc.val_mse.cpu().numpy(), rh.val_mse.numpy()
    require(vc.shape == (3, GROUP_CV_LEN) and bool(np.isfinite(vc).all())
            and bool(np.allclose(vc, vh, rtol=1e-3, atol=0.0)),
            f"small group CV val_mse card {vc.tolist()} CPU {vh.tolist()}")
    log(f"# small group CV 4096x4000 (3 folds, {GROUP_CV_LEN} points): best "
        f"index {rc.best_index}, fold sweeps card {list(rc.fold_sweeps)} "
        f"CPU {list(rh.fold_sweeps)}, val_mse max rel diff "
        f"{float(np.max(np.abs(vc - vh) / np.abs(vh))):.2e}, wall card "
        f"{wc:.2f} s CPU {wh:.2f} s")


def config4_group_path(problem, A_np, b_np, gpu: str, power: str) -> None:
    """Config 4's 10-point group lambda path down to 0.1 lam_max through
    K5's group prox, K6 and K7: K5 launched once per sweep, every point's
    f64 rel_gap at the f32 floor (1e-4), the last point polished by the
    group polish to an f64 rel_gap <= 1e-6."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    m, n = problem.m, problem.n
    cfg = SolverConfig(**C4_PATH)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = cot.lambda_path(problem, cfg, path_len=C4_PATH_LEN,
                          lam_min_frac=C4_LAM_MIN, method="bcd_batch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(res.method_used == "bcd_batch",
            f"config-4 group path ran {res.method_used}")
    require(launches.get("batch_sweep_t", 0) == res.sweeps > 0,
            f"config-4 group path: K5 launches "
            f"{launches.get('batch_sweep_t', 0)} != sweeps {res.sweeps}")
    for name in PATH_KERNELS:
        require(launches.get(name, 0) > 0,
                f"config-4 group path: {name} never launched")
    require(res.xs.shape == (C4_PATH_LEN, n)
            and bool(torch.isfinite(res.xs).all()), "config-4 group path x")
    f64 = certify(problem, res, cfg.tol)
    lam_last = float(res.lambdas[-1])
    pr = cot.polish_support(problem.with_lam1(lam_last), res.xs[-1],
                            tol=1e-6, A_host=A_np, b_host=b_np)
    passes = 1.0 + 2.0 / cfg.gap_every
    groups = (res.xs.view(C4_PATH_LEN, problem.penalty.ngroups, -1)
              .abs().sum(dim=2) > 0).sum(dim=1)
    print(json.dumps({
        "metric": f"config4_group_lambda_path_{C4_PATH_LEN}pt_bcd_batch_"
                  f"{m}x{n}",
        "L": C4_PATH_LEN,
        "lam_min_frac": C4_LAM_MIN,
        "sweeps": res.sweeps,
        "iters": res.iters.tolist(),
        "wall_s": wall,
        "ms_per_sweep": 1e3 * wall / max(res.sweeps, 1),
        "achieved_gb_s": 4.0 * m * n * passes * res.sweeps / wall / 1e9,
        "passes_per_sweep": passes,
        "returned_rel_gap": res.gaps.tolist(),
        "f64_rel_gap": f64,
        "active_groups": groups.tolist(),
        "last_polish_f64_rel_gap": pr.rel_gap,
        "last_polish_wall_s": pr.wall_time_s,
        "lambdas": np.asarray(res.lambdas.cpu()).tolist(),
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    require(max(f64) <= C2_F32_FLOOR, f"config-4 group path f64 gaps {f64}")
    require(pr.rel_gap <= 1e-6,
            f"config-4 group path: last point polished to {pr.rel_gap}")


def config3(device, gpu: str, power: str) -> dict:
    """Config 3 at full size: nonneg elastic net (lam2 1e-3) at 10k x
    100k, solve(bcd_pallas) with gap-safe screening at every check, then
    the f64 polish to rel_gap <= 1e-6.  Returns its sweeps, walls and
    screened count, and the host arrays and lam1 for phase 17."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build

    t0 = time.perf_counter()
    inst, A_np, b_np = make_lasso_instance_host(
        C3_SEED, M, N, penalty_kind="nonneg_l1", lam2=C3_LAM2, device=device)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    problem = inst.problem
    _build.reset_launches()
    res = cot.solve(problem, "bcd_pallas", **C3_SOLVE)
    pr = cot.polish_support(problem, res.x, tol=C3_SOLVE["tol"],
                            A_host=A_np, b_host=b_np)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name in MAIN_KERNELS:
        require(launches.get(name, 0) > 0, f"config 3: {name} never launched")
    require(res.x.shape == (N,) and bool(torch.isfinite(res.x).all())
            and bool((res.x >= 0).all()), "config 3: x")
    require(0 < res.screened < N,
            f"config 3: {res.screened} columns screened at the last check")
    sweeps = res.iterations
    print(json.dumps({
        "metric": f"config3_time_to_certified_1e-06_rel_gap_nonneg_en_"
                  f"{M}x{N}_screened",
        "sweeps": sweeps,
        "screened_at_last_check": res.screened,
        "solve_wall_s": res.wall_time_s,
        "polish_wall_s": pr.wall_time_s,
        "total_s": res.wall_time_s + pr.wall_time_s,
        "ms_per_sweep": 1e3 * res.wall_time_s / max(sweeps, 1),
        "setup_s": res.setup_time_s,
        "datagen_s": datagen_s,
        "nnz": int(np.count_nonzero(pr.x)),
        "f32_rel_gap": res.rel_gap,
        "f64_rel_gap": pr.rel_gap,
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    require(pr.rel_gap <= C3_SOLVE["tol"],
            f"config 3: f64 certificate {pr.rel_gap}")
    return dict(sweeps=sweeps, solve_wall_s=res.wall_time_s,
                polish_wall_s=pr.wall_time_s, screened=res.screened,
                A=A_np, b=b_np, lam1=float(problem.penalty.lam1))


def config4(device, gpu: str, power: str, stats: dict) -> dict:
    """Config 4 at contract size: the group sweeps (K1, K9) and K5's group
    prox against their plain versions (16-block slice, full A_t, timed),
    the certified solve + group polish through K1 (B = 200) and through K9
    (B = 2000), then the group lambda path (config4_group_path).  Returns
    the K9 route's launch counts."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import BENCH_CONFIGS
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.ops.bcd_sweep import (
        pick_block_size_t,
        sweep_route,
    )

    c4 = BENCH_CONFIGS["config4"]
    m, n, ng = c4.m, c4.n, c4.ngroups
    t0 = time.perf_counter()
    inst, A_np, b_np = c4.instance_host(0, device=device)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    problem = inst.problem
    lam1 = float(problem.penalty.lam1)
    log(f"# datagen {m}x{n} group_l2 ({ng} groups): {datagen_s:.2f} s, "
        f"lam1 {lam1:.6g}")
    A_rows = problem.A_rows
    widths = {kernel: B for _, _, B, kernel in C4_ROUTES}
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    cut = 16 * max(widths.values())
    keep = (torch.rand(cut, generator=gen) > 0.1).to(device)
    gsize = n // ng
    compare_group_sweeps(A_rows[:cut], problem.b, lam1, gsize, None, keep,
                         widths, "config4-slice", stats, timed=False)
    timed = compare_group_sweeps(A_rows, problem.b, lam1, gsize, None, None,
                                 widths, "config4-full", stats, timed=True)
    # K5's group prox at L = 10, random weights in [0.5, 1.5)
    w4 = 0.5 + torch.rand(ng, generator=gen).to(device)
    compare_group_batch(A_rows[:16 * GROUP_B], problem.b, gsize,
                        w4[:16 * GROUP_B // gsize], GROUP_B, "config4-slice",
                        stats, False, (gpu, power))
    compare_group_batch(A_rows, problem.b, gsize, w4, GROUP_B, "config4-full",
                        stats, True, (gpu, power))
    del w4
    # K4 on the full A_t at both routes' widths: B = 200 (G_j on chip)
    # and B = 2000 (G in global memory, a launch per step)
    for _, _, B, _ in C4_ROUTES:
        compare_power(A_rows.view(n // B, B, m), f"config4-B{B}", stats,
                      True, (gpu, power))
    k9 = timed["sweep_tiled_t"]
    record(stats, "sweep_tiled_t", k9["max_abs_err"], k9["ms"],
           k9["plain_ms"], None, k9["work"])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(json.dumps({
        "metric": f"config4_group_sweep_ms_{m}x{n}",
        "sweeps": {name: {"bound_ms": 1e3 * t["work"][0] / HBM_BYTES_PER_S}
                   | {k: v for k, v in t.items() if k != "work"}
                   for name, t in timed.items()},
        "gpu": gpu, "power_limit": power}), flush=True)

    k9_launches = {}
    for route, block_size, B, kernel in C4_ROUTES:
        require(pick_block_size_t(n, block_size, n // ng) == (B, 0),
                f"config 4 block_size {block_size} is not B = {B}")
        want = "k1" if kernel == "sweep_t" else "k9"
        require(sweep_route(B, m, sms) == want,
                f"B = {B} routes to {sweep_route(B, m, sms)}, not {want}")
        torch.cuda.synchronize()
        _build.reset_launches()
        res = cot.solve(problem, "bcd_pallas", block_size=block_size,
                        **C4_SOLVE)
        pr = cot.polish_support(problem, res.x, tol=C4_SOLVE["tol"],
                                A_host=A_np, b_host=b_np, verbose=True)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        other = "sweep_tiled_t" if kernel == "sweep_t" else "sweep_t"
        log(f"# config4 {route}: sweeps={res.iterations} f32 rel_gap="
            f"{res.rel_gap:.3e} wall={res.wall_time_s:.3f} s; polish "
            f"rel_gap={pr.rel_gap:.3e} kept={pr.kept} wall="
            f"{pr.wall_time_s:.3f} s; launches {launches}")
        require(launches.get(kernel, 0) == res.iterations > 0,
                f"config4 {route}: {kernel} launches "
                f"{launches.get(kernel, 0)} != sweeps {res.iterations}")
        require(launches.get(other, 0) == 0,
                f"config4 {route}: {other} launched")
        for name in ("ax_minus_b_t", "neg_at_r_t", "block_power_t"):
            require(launches.get(name, 0) > 0,
                    f"config4 {route}: {name} never launched")
        require(res.x.shape == (n,) and bool(torch.isfinite(res.x).all()),
                f"config4 {route}: non-finite or misshapen x")
        require(pr.x.shape == (n,) and bool(np.isfinite(pr.x).all()),
                f"config4 {route}: polish x")
        require(pr.rel_gap <= C4_SOLVE["tol"],
                f"config4 {route}: f64 certificate {pr.rel_gap}")
        ratio = witness_bound_check(problem, pr.x, b_np)
        groups = int((np.abs(pr.x).reshape(ng, -1).sum(axis=1) > 0).sum())
        # K9 reads A again less the chunks its ring keeps
        passes = 1.0 + 2.0 / C4_SOLVE["gap_every"]
        if kernel == "sweep_tiled_t":
            plan = k9_plan(device, B, m)
            passes += (tiled_design_work(m, n, n // B, plan["chunk"],
                                         plan["kept"])[0]
                       - sweep_work(m, n, n // B)[0]) / (4.0 * m * n)
        sweeps = res.iterations
        print(json.dumps({
            "metric": f"config4_time_to_certified_1e-06_rel_gap_group_"
                      f"{m}x{n}_{route}",
            "block": B,
            "sweeps": sweeps,
            "solve_wall_s": res.wall_time_s,
            "polish_wall_s": pr.wall_time_s,
            "polish_gather_s": pr.gather_s,
            "total_s": res.wall_time_s + pr.wall_time_s,
            "ms_per_sweep": 1e3 * res.wall_time_s / max(sweeps, 1),
            "achieved_gb_s": 4.0 * m * n * passes * sweeps
            / res.wall_time_s / 1e9,
            "passes_per_sweep": passes,
            "k4_setup_s": res.setup_time_s,
            "datagen_s": datagen_s,
            "active_groups": groups,
            "kept": pr.kept,
            "polish_sweeps": pr.iterations,
            "f32_rel_gap": res.rel_gap,
            "f64_rel_gap": pr.rel_gap,
            "k3_bound_ratio": ratio,
            "launches": launches,
            "gpu": gpu,
            "power_limit": power,
        }), flush=True)
        if kernel == "sweep_tiled_t":
            k9_launches = launches
    config4_group_path(problem, A_np, b_np, gpu, power)
    return k9_launches


def small_reference(device) -> None:
    """200 x 800: the solve on the card (kernels) against the same solve on
    the CPU (plain versions); both must certify after the polish."""
    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    kw = dict(SOLVE_KW, block_size=40)
    inst_c, A, b = make_lasso_instance_host(0, 200, 800, device=device)
    inst_h, _, _ = make_lasso_instance_host(0, 200, 800, device="cpu")
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


def slab_work(m: int, n: int, n_blocks: int) -> tuple[int, int]:
    """(bytes, flops) of one K8 slab sweep: a sweep's, plus the payload
    (m + 3 floats) out."""
    nbytes, flops = sweep_work(m, n, n_blocks)
    return nbytes + 4 * (m + 3), flops


def compare_slab(A_t, b, pen, keep, label: str, stats: dict,
                 timed: bool) -> None:
    """K8 against its plain version on one slab A_t: the sweep from the
    plain version's first sweep (x = 0, r = -b), so that x . dx is not
    0.  K8's x and r must be K1's on the same slab bit for bit (K8 is K1's
    payload instance on K1's plan).  Tolerances: x, r and the payload's
    dr as K1 (1e-5, 1e-4 past 64 blocks; r and dr relative to ||r||); the
    payload's three scalars against the merge's expressions on K8's own x
    and r to 1e-4 of their magnitude sums (sums of n terms in another
    order)."""
    import torch

    from convex_optimization_tpu_torch.ops import bcd_sweep as k1
    from convex_optimization_tpu_torch.ops import bcd_sweep_slab as k8
    from convex_optimization_tpu_torch.ops import matvec as mv

    nb, B, m = A_t.shape
    n = nb * B
    steps = k1.block_steps(mv.block_power_t_plain(A_t), 0.0)
    x0, r0, _ = k8.sweep_slab_t_plain(
        A_t, torch.zeros(n, device=A_t.device), -b, steps, keep, pen, 0.0)
    args = (A_t, x0, r0, steps, keep, pen, 0.0)
    xk, rk, pk = k8.sweep_slab_t(*args)
    x1, r1 = k1.sweep_t(*args)
    require(torch.equal(xk, x1) and torch.equal(rk, r1),
            f"{label} sweep_slab_t: x or r differs from K1's on the same "
            "slab")
    xp, rp, pp = k8.sweep_slab_t_plain(*args)
    tol = 1e-4 if nb > 64 else 1e-5
    rn = float(torch.linalg.vector_norm(rp))
    ex = float((xk - xp).abs().max())
    require(ex <= tol * max(1.0, float(xp.abs().max())),
            f"{label} sweep_slab_t x err {ex}")
    for what, d in (("r", rk - rp), ("dr", pk[:m] - pp[:m])):
        e = float(torch.linalg.vector_norm(d))
        require(e <= tol * rn, f"{label} sweep_slab_t {what} err {e}")
    if keep is not None:
        require(bool((xk[~keep] == 0).all()),
                f"{label} sweep_slab_t kept a masked x")
    dx = xk - x0
    wmax = 1.0 if pen.weights is None else float(pen.weights.max())
    scale = torch.stack([(x0 * dx).abs().sum(), (dx * dx).sum(),
                         float(pen.lam1) * wmax * dx.abs().sum()])
    es = (pk[m:] - k8.merge_payload(x0, xk, r0, rk, pen)[m:]).abs()
    require(float(scale[1]) > 0 and bool((es <= 1e-4 * scale).all()),
            f"{label} sweep_slab_t payload scalars {pk[m:].tolist()} err "
            f"{es.tolist()} scale {scale.tolist()}")
    err = max(ex, float((rk - rp).abs().max()),
              float((pk[:m] - pp[:m]).abs().max()))
    times = (time_ms(lambda: k8.sweep_slab_t(*args), 10),
             time_ms(lambda: k8.sweep_slab_t_plain(*args), 1), None,
             slab_work(m, n, nb)) if timed else ()
    record(stats, "sweep_slab_t", err, *times)
    torch.cuda.synchronize()
    log(f"# K8 vs plain [{label}] slab={tuple(A_t.shape)} {pen.kind}: ok "
        f"(x err {ex:.3e}, payload {pk[m:].tolist()})")
    if timed:
        # K1 on the same slab
        k1_ms = time_ms(lambda: k1.sweep_t(*args), 5)
        log(f"# K8 {times[0]:.3f} ms, K1 {k1_ms:.3f} ms, plain "
            f"{times[1]:.3f} ms on the same slab {tuple(A_t.shape)}")
        print(json.dumps({
            "metric": f"k8_slab_sweep_ms_A_t_{nb}x{B}x{m}",
            "ms": times[0], "us_per_block": 1e3 * times[0] / nb,
            "k1_ms_same_slab": k1_ms, "plain_ms": times[1],
            "bound_ms": stats["sweep_slab_t"]["bound_ms"],
            "plan": k1_plan(A_t.device, B, m)}), flush=True)


def first_check_at(rel_gaps, level: float):
    """Index of the first check whose rel_gap is <= level, else None."""
    return next((i for i, v in enumerate(rel_gaps) if v <= level), None)


def path_numbers(card: dict, cpu: dict, tol: float) -> dict:
    """What ``path_check`` compares: over the checks both runs reached, the
    largest relative difference of the primal objectives and the largest
    ratio of the f32 rel_gap readings (either way round) while the CPU's
    is >= PATH_LEVELS[0] x tol; per level of PATH_LEVELS, the card's first
    crossing minus the CPU's, in checks (None where a run never reached
    the level); the card's last decade (checks from its first reading <=
    PATH_LEVELS[0] x tol to its last check) minus the CPU's."""
    n = min(len(card["primal"]), len(cpu["primal"]))
    pc = [float(v) for v in card["primal"][:n]]
    ph = [float(v) for v in cpu["primal"][:n]]
    ratios = [max(a / b, b / a) if a > 0 else math.inf
              for a, b in zip(card["rel_gap"][:n], cpu["rel_gap"][:n])
              if b >= PATH_LEVELS[0] * tol]
    shifts = {}
    for f in PATH_LEVELS:
        ic = first_check_at(card["rel_gap"], f * tol)
        ih = first_check_at(cpu["rel_gap"], f * tol)
        shifts[f"{f * tol:g}"] = (None if ic is None or ih is None
                                  else ic - ih)
    ic, ih = (first_check_at(run["rel_gap"], PATH_LEVELS[0] * tol)
              for run in (card, cpu))
    last = (None if ic is None or ih is None
            else (len(card["rel_gap"]) - ic) - (len(cpu["rel_gap"]) - ih))
    return dict(primal_rel_diff=max(abs(a - b) / abs(b)
                                    for a, b in zip(pc, ph)),
                rel_gap_ratio=max(ratios, default=1.0),
                crossing_shift=shifts, last_decade_shift=last, checks=n)


def path_check(card: dict, cpu: dict, tol: float, gap_every: int
               ) -> list[str]:
    """The failures of a card run held to the CPU run of the same input,
    method and penalty (an empty list: it passes).  Each run is a dict of
    its history (``primal``, ``rel_gap``: one entry per check, check 0 at
    the start), ``converged`` (stopped at rel_gap <= tol, not on the stall
    rule or max_iters), ``f64_rel_gap`` (the f64 gap of the returned x
    before the polish) and, after the polish, ``polished_rel_gap`` and
    ``support``.  Required:

      1. the same path: the primal objective at every check both runs
         reached within PATH_RTOL, and the f32 rel_gap within a factor of
         PATH_GAP_FACTOR while the CPU's is >= PATH_LEVELS[0] x tol (near
         the optimum the primal moves with the square of the iterate's
         error, the gap with the error itself);
      2. the same speed: for each level in PATH_LEVELS x tol, the first
         check at which the f32 rel_gap is <= the level within one check
         of the CPU's; and the checks from the first reading <=
         PATH_LEVELS[0] x tol to the stop within PATH_LAST_DECADE of the
         CPU's (a fault that slows only the last decade);
      3. a real stop: both converged; the card's f64 gap before the polish
         <= 2 tol, or twice the CPU's where the CPU's is above tol (the
         sharded BCD never refreshes r, so its f32 reading carries r's
         drift: the CPU's l1 run reads <= 1e-6 at an f64 gap of 3e-6 to
         6e-6); after the polish both <= tol with the same support."""
    out = []
    nums = path_numbers(card, cpu, tol)
    if not nums["primal_rel_diff"] <= PATH_RTOL:
        out.append(f"primal objectives part by {nums['primal_rel_diff']:.3e}"
                   f" (relative) within {nums['checks']} checks")
    if not nums["rel_gap_ratio"] <= PATH_GAP_FACTOR:
        out.append(f"f32 rel_gap readings part by a factor of "
                   f"{nums['rel_gap_ratio']:.3f} above "
                   f"{PATH_LEVELS[0] * tol:g}")
    for level, shift in nums["crossing_shift"].items():
        if shift is None or abs(shift) > 1:
            out.append(f"first check at rel_gap <= {level}: card "
                       f"{first_check_at(card['rel_gap'], float(level))}, "
                       f"CPU {first_check_at(cpu['rel_gap'], float(level))}"
                       f" (checks of {gap_every} steps)")
    last = nums["last_decade_shift"]
    if last is not None and abs(last) > PATH_LAST_DECADE:
        out.append(f"last decade {last:+d} checks against the CPU's (checks"
                   f" of {gap_every} steps)")
    for name, run in (("card", card), ("CPU", cpu)):
        if not run["converged"]:
            out.append(f"{name} run did not converge (last rel_gap "
                       f"{run['rel_gap'][-1]})")
        if not run["polished_rel_gap"] <= tol:
            out.append(f"{name} polished f64 gap {run['polished_rel_gap']}")
    if not card["f64_rel_gap"] <= 2 * max(tol, cpu["f64_rel_gap"]):
        out.append(f"card f64 gap before the polish {card['f64_rel_gap']}"
                   f" (CPU {cpu['f64_rel_gap']})")
    if not bool((card["support"] == cpu["support"]).all()):
        out.append("support differs from the CPU's after the polish")
    return out


def path_run(problem, run: dict, A_host, b_host, polish_tol: float) -> dict:
    """``run`` (a sharded solve's gathered ``x``, history ``primal`` and
    ``rel_gap``, ``converged``) with what ``path_check`` reads of its x:
    the f64 gap before the polish, and the f64 gap and support of the
    polish to ``polish_tol``."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot

    x = torch.from_numpy(np.asarray(run["x"]))
    pr = cot.polish_support(problem, x, tol=polish_tol, A_host=A_host,
                            b_host=b_host)
    return dict(run, f64_rel_gap=float(cot.duality_gap(
        problem, x, precise=True).rel_gap),
        polished_rel_gap=pr.rel_gap, support=np.abs(pr.x) > 1e-4)


def sharded_ranks_job(g, A_s, b_s, pens_s, A_shared, b_h, lam_h) -> dict:
    """Phase 10 in each of the SHARD_P ranks (gloo, the ranks share the
    card).  The collectives on CUDA tensors: the psum path's ops exact,
    the ring and the reduce-scatter refused up front with the port's own
    error (any other outcome fails the rank; nothing moves to the CPU);
    the 500 x 2000 sharded BCD and FISTA (l1) and BCD (weighted group_l2;
    ``pens_s``: problem_from_numpy's penalty arguments of each) on the
    card with psum and on the CPU (plain versions) in every mode; then the
    headline 10k x 100k sharded BCD from the shared-memory A, and the
    all-reduce of one step's payload timed alone."""
    import dataclasses

    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.problem import (
        Problem,
        problem_from_numpy,
    )
    from convex_optimization_tpu_torch.models.penalties import l1
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.parallel import collectives as col

    def sync():
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)

    cpu = dataclasses.replace(g, device=torch.device("cpu"))
    # v_r = base + r / 2 sums exactly in f32
    P = g.size
    base = torch.arange(4 * P, dtype=torch.float32, device=g.device)
    v = base + 0.5 * g.rank
    total = P * base + 0.25 * P * (P - 1)
    exact = {}
    for name, fn, want in (
            ("psum", lambda: col.psum(v.clone(), g), total),
            ("pmax", lambda: col.pmax(v.clone(), g), base + 0.5 * (P - 1)),
            ("broadcast0", lambda: col.broadcast0(v.clone(), g), base),
            ("all_gather", lambda: col.all_gather(v, g),
             torch.cat([base + 0.5 * r for r in range(P)]))):
        exact[name] = float((fn() - want).abs().max())
    refused = {}
    for name, fn in (("ring", lambda: col.ring_psum(v, g)),
                     ("reduce_scatter",
                      lambda: col.reduce_scatter_gather(v, g))):
        try:
            fn()
        except RuntimeError as e:
            msg = str(e).splitlines()[0]
            if not msg.startswith("gloo takes no CUDA"):
                raise
            refused[name] = msg
        else:
            raise RuntimeError(f"{name} ran over gloo on CUDA tensors; the "
                               "port refuses it there")
    exact["psum_after"] = float((col.psum(v.clone(), g) - total).abs().max())
    sync()

    p_small = {k: problem_from_numpy(A_s, b_s, device="cpu", **pen)
               for k, pen in pens_s.items()}
    small = {}
    for where, gg in (("card", g), ("cpu", cpu)):
        for kind, method, kw in (("l1", "bcd_pallas", SHARD_BCD),
                                 ("l1", "fista", SHARD_FISTA),
                                 ("group_l2", "bcd_pallas", SHARD_BCD)):
            for mode in (("psum",) if where == "card"
                         else ("psum", "ring", "reduce_scatter")):
                _build.reset_launches()
                res = cot.solve(p_small[kind], method, mesh=gg,
                                consensus=mode, **kw)
                small[(where, method, mode, kind)] = dict(
                    x=res.x.cpu().numpy(), k=res.iterations,
                    best_rel_gap=res.rel_gap, wall=res.wall_time_s,
                    primal=res.history["primal"].tolist(),
                    rel_gap=res.history["rel_gap"].tolist(),
                    converged=bool(res.converged),
                    launches=dict(_build.launches))

    p_head = Problem(A_t=A_shared.unsqueeze(1), b=b_h, penalty=l1(lam_h))
    sync()
    _build.reset_launches()
    res = cot.solve(p_head, "bcd_pallas", mesh=g, **SOLVE_KW)
    sync()
    launches = dict(_build.launches)
    pay = torch.zeros(p_head.m + 3, device=g.device)
    col.psum(pay, g)
    sync()
    t0 = time.perf_counter()
    for _ in range(50):
        col.psum(pay, g)
    sync()
    ar_ms = 1e3 * (time.perf_counter() - t0) / 50
    head = dict(k=res.iterations, rel_gap=res.rel_gap, wall=res.wall_time_s,
                setup=res.setup_time_s, launches=launches, allreduce_ms=ar_ms,
                rel_gaps=res.history["rel_gap"].tolist(),
                x=res.x.cpu().numpy() if g.rank == 0 else None)
    return dict(exact=exact, refused=refused, small=small, head=head)


def shard_small_instance():
    """The small sharded runs' instance (SHARD_SMALL, host arrays) and
    ``problem_from_numpy``'s penalty arguments of its l1 and its weighted
    group_l2 (SHARD_GROUPS groups, weights in [0.5, 1.5), 0.1 lam_max)."""
    import numpy as np

    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )

    small, A_s, b_s = make_lasso_instance_host(*SHARD_SMALL, device="cpu")
    w_s = np.random.default_rng(SHARD_SMALL[0]).uniform(
        0.5, 1.5, SHARD_GROUPS).astype(np.float32)
    g_norms = np.linalg.norm((A_s.T @ b_s).reshape(SHARD_GROUPS, -1), axis=1)
    return A_s, b_s, {
        "l1": dict(penalty_kind="l1", lam1=float(small.problem.penalty.lam1)),
        "group_l2": dict(penalty_kind="group_l2", ngroups=SHARD_GROUPS,
                         weights=w_s,
                         lam1=float(0.1 * (g_norms / w_s).max()))}


def sharded_phase(device, problem, A_np, b_np, gpu: str, power: str
                  ) -> int:
    """Phase 10: the column-sharded path.  Returns K8's launches on the
    headline sharded solve (all ranks)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.parallel.launch import run_ranks
    from convex_optimization_tpu_torch.parallel.mesh import init_multihost

    A_s, b_s, pens_s = shard_small_instance()
    probs_s = {k: cot.problem_from_numpy(A_s, b_s, device="cpu", **pen)
               for k, pen in pens_s.items()}
    # the ranks map the headline A from shared memory (no pickled copy)
    A_shared = torch.from_numpy(np.ascontiguousarray(A_np.T)).share_memory_()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(sharded_ranks_job, SHARD_P, tmp, A_s, b_s, pens_s,
                          A_shared, torch.from_numpy(b_np),
                          float(problem.penalty.lam1),
                          device=str(device), backend="gloo",
                          timeout_s=900, collective_timeout_s=300)
    ranks_s = time.perf_counter() - t0
    del A_shared
    r0 = ranks[0]
    for rank in ranks:
        require(all(e == 0.0 for e in rank["exact"].values()),
                f"gloo collectives on CUDA tensors: errors {rank['exact']}")
        require(sorted(rank["refused"]) == ["reduce_scatter", "ring"],
                f"gloo on CUDA tensors refused {rank['refused']}")
    refused = r0["refused"]

    # the small runs: each certified after the polish; each card run held
    # to the CPU run of the same input, method and penalty by path_check
    smalls = {}
    polished = {}
    for key, run in r0["small"].items():
        polished[key] = path_run(probs_s[key[3]], run, A_s, b_s, 1e-6)
        pr_gap = polished[key]["polished_rel_gap"]
        require(pr_gap <= 1e-6, f"sharded small {key}: f64 gap {pr_gap}")
        smalls["/".join(key)] = dict(
            k=run["k"], f32_rel_gap=run["best_rel_gap"],
            f64_rel_gap_unpolished=polished[key]["f64_rel_gap"],
            f64_rel_gap=pr_gap, wall_s=run["wall"])
    for key in polished:
        if key[0] != "card":
            continue
        if key[1] == "bcd_pallas":
            for rank in ranks:
                lc = rank["small"][key]["launches"]
                require(lc.get("sweep_slab_t", 0) > 0
                        and lc.get("sweep_t", 0) == 0,
                        f"sharded small {key}: launches {lc}")
        kw = SHARD_BCD if key[1] == "bcd_pallas" else SHARD_FISTA
        ref = polished[("cpu",) + key[1:]]
        fails = path_check(polished[key], ref, kw["tol"], kw["gap_every"])
        require(not fails, f"sharded small {key} against the CPU: "
                f"{'; '.join(fails)}")
        smalls["/".join(key)]["path"] = path_numbers(polished[key], ref,
                                                     kw["tol"])
    for key in polished:
        other = ("cpu",) + key[1:] if key[0] == "card" else key
        require(bool((polished[key]["support"]
                      == polished[other]["support"]).all()),
                f"sharded small {key}: support differs from the CPU's")
    log(f"# sharded small {SHARD_SMALL[1]}x{SHARD_SMALL[2]} P={SHARD_P}: "
        f"{smalls}; refused on gloo with CUDA tensors: {refused}")

    # the headline: x gathered in the ranks, polished here
    head = r0["head"]
    for rank in ranks:
        lc = rank["head"]["launches"]
        require(lc.get("sweep_slab_t", 0) > 0 and lc.get("sweep_t", 0) == 0,
                f"sharded headline launches {lc}")
        require(rank["head"]["k"] == head["k"], "ranks disagree on steps")
    x = head["x"]
    require(x.shape == (problem.n,) and bool(np.isfinite(x).all()),
            "sharded headline x")
    pr = cot.polish_support(problem, torch.from_numpy(x).to(device),
                            tol=SOLVE_KW["tol"], A_host=A_np, b_host=b_np)
    require(pr.rel_gap <= SOLVE_KW["tol"],
            f"sharded headline f64 certificate {pr.rel_gap}")
    k8_launches = sum(r["head"]["launches"].get("sweep_slab_t", 0)
                      for r in ranks)
    print(json.dumps({
        "metric": "sharded_time_to_certified_1e-06_rel_gap_lasso_"
                  f"{problem.m}x{problem.n}_{SHARD_P}ranks_1card",
        "sweeps": head["k"],
        "solve_wall_s": head["wall"],
        "polish_wall_s": pr.wall_time_s,
        "total_s": head["wall"] + pr.wall_time_s,
        "ms_per_step": 1e3 * head["wall"] / max(head["k"], 1),
        "allreduce_ms": head["allreduce_ms"],
        "allreduce_share": head["k"] * head["allreduce_ms"]
        / (1e3 * head["wall"]),
        "k4_setup_s": head["setup"],
        "f32_rel_gap": head["rel_gap"],
        "f64_rel_gap": pr.rel_gap,
        "nnz": int(np.count_nonzero(pr.x)),
        "launches_per_rank": [r["head"]["launches"] for r in ranks],
        "ranks_wall_s": ranks_s,
        "refused_on_gloo_cuda": refused,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)

    # a world-size-1 NCCL group: the NCCL code path, against the
    # single-device solve on the same card
    small_c, _, _ = make_lasso_instance_host(*SHARD_SMALL, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        g1 = init_multihost(f"file://{tmp}/store", 0, 1, device)
        try:
            require(g1.backend == "nccl", f"backend {g1.backend}")
            nccl = {}
            for method, kw in (("bcd_pallas", SHARD_BCD),
                               ("fista", SHARD_FISTA)):
                # the sharded BCD at P = 1 skips the per-check residual
                # refresh and sweeps with K8, not K1: the step counts
                # may part by a few checks near the f32 floor, so the
                # certificates and supports are compared
                res_s = cot.solve(small_c.problem, method, mesh=g1, **kw)
                res_1 = cot.solve(small_c.problem, method, **kw)
                require(res_s.method == f"sharded_{method.split('_')[0]}",
                        f"NCCL run method {res_s.method}")
                prs = [cot.polish_support(small_c.problem, r.x, tol=1e-6,
                                          A_host=A_s, b_host=b_s)
                       for r in (res_s, res_1)]
                require(max(pr.rel_gap for pr in prs) <= 1e-6,
                        f"NCCL {method} f64 gaps {[p.rel_gap for p in prs]}")
                require(bool(((abs(prs[0].x) > 1e-4)
                              == (abs(prs[1].x) > 1e-4)).all()),
                        f"NCCL {method}: support differs from the single "
                        "device's")
                nccl[method] = dict(k=res_s.iterations,
                                    single_device_k=res_1.iterations,
                                    f64_rel_gap=prs[0].rel_gap)
        finally:
            dist.destroy_process_group()
    log(f"# NCCL world-size-1 group: {nccl}")

    # single-device FISTA, 2000 x 10000, card against CPU
    kw = dict(SHARD_FISTA, max_iters=5000)
    inst_c, A_m, b_m = make_lasso_instance_host(*FISTA_MID, device=device)
    inst_h, _, _ = make_lasso_instance_host(*FISTA_MID, device="cpu")
    _build.reset_launches()
    res_c = cot.solve(inst_c.problem, "fista", **kw)
    lc = dict(_build.launches)
    require(lc.get("ax_minus_b_t", 0) > res_c.iterations > 0
            and lc.get("neg_at_r_t", 0) > res_c.iterations,
            f"FISTA on the card launches {lc}")
    res_h = cot.solve(inst_h.problem, "fista", **kw)
    require(abs(res_c.iterations - res_h.iterations) <= kw["gap_every"],
            f"FISTA {res_c.iterations} steps on the card, "
            f"{res_h.iterations} on the CPU")
    supports = []
    for res in (res_c, res_h):
        prf = cot.polish_support(inst_h.problem, res.x.cpu(), tol=1e-6,
                                 A_host=A_m, b_host=b_m)
        require(prf.rel_gap <= 1e-6, f"FISTA polish gap {prf.rel_gap}")
        supports.append(np.abs(prf.x) > 1e-4)
    require(bool((supports[0] == supports[1]).all()),
            "FISTA supports differ card vs CPU")
    log(f"# FISTA {FISTA_MID[1]}x{FISTA_MID[2]}: card {res_c.iterations} "
        f"steps {res_c.wall_time_s:.3f} s (L_total {res_c.setup_time_s:.3f}"
        f" s), CPU {res_h.iterations} steps {res_h.wall_time_s:.3f} s")
    return k8_launches


def ws_headline(problem, A_np, b_np, gpu: str, power: str,
                main: dict) -> dict:
    """Phase 12: solve(fista_ws) and solve(bcd_ws, block_size=128) at the
    headline with the main path's settings, each polished to an f64
    rel_gap <= 1e-6; K2 and K3 (and K1 and K4 for bcd_ws) launched, the
    last working set smaller than n.  Their time to the certificate
    beside the main path's (``main``).  Returns the launch counts."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build

    out = {}
    for method in ("fista_ws", "bcd_ws"):
        torch.cuda.synchronize()
        _build.reset_launches()
        res = cot.solve(problem, method, **SOLVE_KW)
        pr = cot.polish_support(problem, res.x, tol=SOLVE_KW["tol"],
                                A_host=A_np, b_host=b_np)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        h = res.history
        print(json.dumps({
            "metric": f"{method}_time_to_certified_1e-06_rel_gap_lasso_"
                      f"{M}x{N}",
            "rounds": h["rounds"],
            "inner_iters": h["inner_iters"],
            "ws_size": h["ws_size"],
            "setup_s": res.setup_time_s,
            "burn_s": h["burn_s"],
            "rounds_s": h["wall_s"] - h["setup_s"] - h["burn_s"],
            "solve_wall_s": res.wall_time_s,
            "polish_wall_s": pr.wall_time_s,
            "total_s": res.wall_time_s + pr.wall_time_s,
            "bcd_pallas_solve_wall_s": main["solve_wall_s"],
            "bcd_pallas_polish_wall_s": main["polish_wall_s"],
            "bcd_pallas_total_s": main["total_s"],
            "f32_rel_gap": res.rel_gap,
            "f64_rel_gap": pr.rel_gap,
            "nnz": int(np.count_nonzero(pr.x)),
            "launches": launches,
            "gpu": gpu,
            "power_limit": power,
        }), flush=True)
        require(res.x.shape == (N,) and bool(torch.isfinite(res.x).all()),
                f"{method}: x")
        need = ("ax_minus_b_t", "neg_at_r_t") + (
            ("sweep_t", "block_power_t") if method == "bcd_ws" else ())
        for name in need:
            require(launches.get(name, 0) > 0,
                    f"{method}: {name} never launched")
        require(h["ws_size"] < N, f"{method}: working set {h['ws_size']}")
        require(pr.rel_gap <= SOLVE_KW["tol"],
                f"{method}: f64 certificate {pr.rel_gap}")
        out[method] = launches
    return out


def admm_headline(problem, A_np, b_np, gpu: str, power: str) -> dict:
    """Phase 13a: solve(admm, admm_setup="host") at the headline (the
    Woodbury route, m = 10000: the Gram on the card, its f64 eigh on the
    host) with the JAX package's at-scale settings, polished to an f64
    rel_gap <= 1e-6.  Returns the launch counts."""
    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    res = cot.solve(problem, "admm", admm_setup="host", **ADMM_KW)
    pr = cot.polish_support(problem, res.x, tol=ADMM_KW["tol"],
                            A_host=A_np, b_host=b_np)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    print(json.dumps({
        "metric": f"admm_host_time_to_certified_1e-06_rel_gap_lasso_{M}x{N}",
        "gram_s": res.history["gram_s"],
        "eigh_s": res.history["eigh_s"],
        "setup_s": res.setup_time_s,
        "iterations": res.iterations,
        "solve_wall_s": res.wall_time_s,
        "ms_per_iteration": 1e3 * res.wall_time_s / max(res.iterations, 1),
        "polish_wall_s": pr.wall_time_s,
        "total_s": res.wall_time_s + pr.wall_time_s,
        "f32_rel_gap": res.rel_gap,
        "f64_rel_gap": pr.rel_gap,
        "nnz": int(np.count_nonzero(pr.x)),
        "launches": launches,
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    require(res.method == "admm", f"headline ADMM ran {res.method}")
    require(res.x.shape == (N,) and bool(torch.isfinite(res.x).all()),
            "headline ADMM: x")
    for name in ("ax_minus_b_t", "neg_at_r_t"):
        require(launches.get(name, 0) > res.iterations,
                f"headline ADMM: {name} launches {launches.get(name, 0)}")
    require(pr.rel_gap <= ADMM_KW["tol"],
            f"headline ADMM: f64 certificate {pr.rel_gap}")
    return launches


def admm_small(device, gpu: str, power: str) -> None:
    """Phase 13b: the device set-up (min(m, n) <= the fence: an f32 eigh
    on the card) at ADMM_SMALL, on the card and on the CPU: both converge,
    both certify after the polish, with the same support."""
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.api import ADMM_FENCE_DIM
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build

    seed, m, n = ADMM_SMALL
    require(min(m, n) <= ADMM_FENCE_DIM, "ADMM_SMALL is above the fence")
    inst_c, A, b = make_lasso_instance_host(seed, m, n, device=device)
    inst_h, _, _ = make_lasso_instance_host(seed, m, n, device="cpu")
    out = {}
    for where, inst in (("card", inst_c), ("cpu", inst_h)):
        _build.reset_launches()
        res = cot.solve(inst.problem, "admm", **ADMM_SMALL_KW)
        pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                                b_host=b)
        out[where] = dict(iterations=res.iterations, wall_s=res.wall_time_s,
                          setup_s=res.setup_time_s,
                          eigh_s=res.history["eigh_s"],
                          f32_rel_gap=res.rel_gap, converged=res.converged,
                          f64_rel_gap=pr.rel_gap,
                          support=np.abs(pr.x) > 0,
                          launches=dict(_build.launches))
    c, h = out["card"], out["cpu"]
    same = bool((c.pop("support") == h.pop("support")).all())
    print(json.dumps({"metric": f"admm_device_setup_card_vs_cpu_{m}x{n}",
                      **{f"{k}_{w}": v for w, d in out.items()
                         for k, v in d.items()},
                      "same_support": same, "gpu": gpu,
                      "power_limit": power}), flush=True)
    require(c["launches"].get("neg_at_r_t", 0) > c["iterations"],
            "small ADMM: K3 not launched per iteration")
    require(c["converged"] and h["converged"],
            f"small ADMM: converged card={c['converged']} "
            f"cpu={h['converged']}")
    require(max(c["f64_rel_gap"], h["f64_rel_gap"]) <= 1e-6,
            "small ADMM: f64 certificates")
    require(same, "small ADMM: supports differ card vs CPU")


def config2_new_paths(device, gpu: str, power: str, bcd_wall: float,
                      fista_wall: float) -> dict:
    """Phase 14: config 2's 10-point grid with the compacting path, the
    bcd_ws and fista_ws paths and the ADMM path (admm_setup="host":
    min(m, n) = 5000 is above the fence), phase 7's settings; every
    converged point's f64 rel_gap <= the f32 floor, as phase 7 reads its
    FISTA path.  Walls beside phase 7's bcd_batch and FISTA paths.
    Returns each path's launch counts."""
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    inst2, _, _ = make_lasso_instance_host(C2_SEED, C2_M, C2_N,
                                           device=device)
    problem = inst2.problem
    cfg = SolverConfig(**C2_CFG)
    out = {}
    for name, kw, used in (
            ("compact", dict(compact=True), "fista_compact"),
            ("bcd_ws", dict(method="bcd_ws"), "bcd_ws"),
            ("fista_ws", dict(method="fista_ws"), "fista_ws"),
            ("admm_host", dict(method="admm", admm_setup="host"), "admm")):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = cot.lambda_path(problem, cfg, path_len=C2_LEN, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        f64 = certify(problem, res, cfg.tol)
        conv = res.converged.cpu().tolist()
        print(json.dumps({
            "metric": f"config2_lambda_path_{C2_LEN}pt_{name}_{C2_M}x{C2_N}",
            "method_used": res.method_used,
            "wall_s": wall,
            "bcd_batch_wall_s": bcd_wall,
            "fista_path_wall_s": fista_wall,
            "sweeps": res.sweeps,
            "iters": res.iters.tolist(),
            "kept": None if res.kept is None else res.kept.tolist(),
            "converged": conv,
            "f32_rel_gap": res.gaps.tolist(),
            "f64_rel_gap": f64,
            "nnz": (res.xs != 0).sum(dim=1).tolist(),
            "launches": launches,
            "gpu": gpu,
            "power_limit": power,
        }), flush=True)
        require(res.method_used == used,
                f"config-2 {name} path ran {res.method_used}")
        require(res.xs.shape == (C2_LEN, C2_N)
                and bool(torch.isfinite(res.xs).all()),
                f"config-2 {name} path x")
        for k in ("ax_minus_b_t", "neg_at_r_t"):
            require(launches.get(k, 0) > 0, f"{name} path: {k} never "
                    "launched")
        if name == "bcd_ws":
            require(launches.get("sweep_t", 0) > 0
                    and launches.get("block_power_t", 0) > 0,
                    "bcd_ws path: K1 or K4 never launched")
        bad = [g for g, c in zip(f64, conv) if c and g > C2_F32_FLOOR]
        require(not bad, f"config-2 {name} path: converged points with "
                f"f64 gaps {bad}")
        out[name] = launches
    del problem, inst2
    torch.cuda.empty_cache()
    return out


def group_ws_reference(device, gpu: str, power: str) -> dict:
    """Phase 15: bcd_ws (whole groups; K1's group prox on the slabs) on
    small_group_reference's instance at lam1 = GROUP_WS_LAM lam_max, tol
    1e-6, on the card and on the CPU: the same
    rounds, working sets within one bucket, both polished to 1e-6 with the
    same active groups.  Returns the card run's launch counts."""
    import numpy as np

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.ops import _build

    kw = dict(penalty_kind="group_l2", ngroups=40, lam1_frac=GROUP_WS_LAM)
    inst_c, A, b = make_lasso_instance_host(4, 4096, 4000, device=device,
                                            **kw)
    inst_h, _, _ = make_lasso_instance_host(4, 4096, 4000, device="cpu",
                                            **kw)
    solve_kw = dict(C4_SOLVE, block_size=128)
    out = {}
    for where, inst in (("card", inst_c), ("cpu", inst_h)):
        _build.reset_launches()
        res = cot.solve(inst.problem, "bcd_ws", **solve_kw)
        pr = cot.polish_support(inst.problem, res.x, tol=1e-6, A_host=A,
                                b_host=b)
        out[where] = dict(rounds=res.history["rounds"],
                          inner_iters=res.iterations,
                          ws_size=res.history["ws_size"],
                          wall_s=res.wall_time_s, f32_rel_gap=res.rel_gap,
                          f64_rel_gap=pr.rel_gap,
                          groups=np.abs(pr.x).reshape(40, -1).sum(axis=1) > 0,
                          launches=dict(_build.launches))
    c, h = out["card"], out["cpu"]
    same = bool((c["groups"] == h["groups"]).all())
    n_groups = int(c.pop("groups").sum())
    h.pop("groups")
    print(json.dumps({"metric": "group_bcd_ws_card_vs_cpu_4096x4000",
                      **{f"{k}_{w}": v for w, d in out.items()
                         for k, v in d.items()},
                      "active_groups": n_groups, "same_groups": same,
                      "gpu": gpu, "power_limit": power}), flush=True)
    for k in ("sweep_t", "block_power_t", "ax_minus_b_t", "neg_at_r_t"):
        require(c["launches"].get(k, 0) > 0,
                f"group bcd_ws: {k} never launched")
    require(c["rounds"] == h["rounds"],
            f"group bcd_ws rounds {c['rounds']} vs {h['rounds']}")
    require(abs(c["ws_size"] - h["ws_size"]) <= 128 and c["ws_size"] < 4000,
            f"group bcd_ws working sets {c['ws_size']} vs {h['ws_size']}")
    require(max(c["f64_rel_gap"], h["f64_rel_gap"]) <= 1e-6,
            "group bcd_ws: f64 certificates")
    require(same, "group bcd_ws: active groups differ card vs CPU")
    return c["launches"]


def headline_polishes(problem, x_head, A_np, b_np, support, support_wall,
                      gpu: str, power: str) -> None:
    """Phase 16, first part: ``polish`` (two chunked f64 host passes) and
    ``polish_fast``'s device variant (K3's witness on the card, inflated
    by its rounding bound) at phase 4's f32 x: each certified <= 1e-6
    with the support of phase 4's ``polish_support``, K3 launched once by
    ``polish_fast``; their walls beside ``polish_support``'s."""
    import numpy as np
    import torch

    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.polish import (
        polish,
        polish_fast,
    )

    tol = SOLVE_KW["tol"]
    out = {}
    for name, fn, kw in (("polish", polish, dict(A_host=A_np, b_host=b_np)),
                         ("polish_fast_device", polish_fast, {})):
        torch.cuda.synchronize()
        _build.reset_launches()
        pr = fn(problem, x_head, tol=tol, **kw)
        torch.cuda.synchronize()
        out[name] = dict(wall_s=pr.wall_time_s, f64_rel_gap=pr.rel_gap,
                         kept=pr.kept, iterations=pr.iterations,
                         same_support=bool(np.array_equal(pr.x != 0,
                                                          support)),
                         launches=dict(_build.launches))
    print(json.dumps({
        "metric": f"headline_polish_variants_{M}x{N}",
        **{f"{k}_{name}": v for name, d in out.items() for k, v in d.items()},
        "polish_support_wall_s": support_wall,
        "support_size": int(support.sum()),
        "gpu": gpu, "power_limit": power}), flush=True)
    for name, d in out.items():
        require(d["f64_rel_gap"] <= tol,
                f"{name}: f64 certificate {d['f64_rel_gap']}")
        require(d["same_support"], f"{name}: support differs from "
                "polish_support's")
    require(out["polish_fast_device"]["launches"].get("neg_at_r_t") == 1,
            "polish_fast (device): K3 not launched once")


class captured:
    """Record (args, kwargs, result) of every call of ``module.name``
    inside the ``with`` block (the CLI looks its solvers up at call
    time), so a phase can check what the CLI solved."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrap(*args, **kwargs):
            result = self.orig(*args, **kwargs)
            self.calls.append((args, kwargs, result))
            return result

        setattr(self.module, self.name, wrap)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_cli(argv: list) -> tuple:
    """``cli.main(argv)`` in this process with the launch counts set to 0
    just before it: (its JSON line, the launches, the wall)."""
    import contextlib
    import io

    import torch

    from convex_optimization_tpu_torch import cli
    from convex_optimization_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    require(rc == 0, f"cli {argv}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), launches, \
        wall


def front_door(device, gpu: str, power: str, c3_walls: dict,
               c2_fista_wall: float) -> None:
    """Phase 16: the CLI (``cli.main``) on the card.  Config 3 at full
    width with the polish, a snapshot and JSONL, then resumed from the
    snapshot (fewer sweeps); every run's snapshot certified by the port's
    f64 gap, and the CLI's own certificate where it polished.  Config 2's
    10-point FISTA path (every converged point <= 1e-4 in f64), config 1's
    3-fold CV, config 4's CI twin, and config 5's CI twin over a
    world-size-1 NCCL group (K8, not K1)."""
    import tempfile

    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch import api
    from convex_optimization_tpu_torch.solvers import lambda_path as lp_mod
    from convex_optimization_tpu_torch.utils.checkpoint import load_snapshot

    tol = SOLVE_KW["tol"]

    def line(metric, out, launches, wall, **extra):
        print(json.dumps({"metric": metric, "cli": out, "cli_wall_s": wall,
                          "launches": launches, **extra, "gpu": gpu,
                          "power_limit": power}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        snap, jl = os.path.join(tmp, "c3.npz"), os.path.join(tmp, "c3.jsonl")
        argv = FRONT_C3 + ["--checkpoint", snap, "--jsonl", jl]
        sweeps = {}
        for run, extra in (("first", []), ("resume", ["--resume"])):
            with captured(api, "solve") as calls:
                out, launches, wall = run_cli(argv + extra)
            problem = calls[0][0][0]
            x = torch.from_numpy(load_snapshot(snap).x).to(device)
            f64 = float(cot.duality_gap(problem, x, precise=True).rel_gap)
            with open(jl) as f:
                first_record = json.loads(f.readline())["record"]
            del calls, problem, x
            torch.cuda.empty_cache()
            sweeps[run] = out["iterations"]
            line(f"cli_config3_{run}_{M}x{N}", out, launches, wall,
                 f64_rel_gap_snapshot=f64, jsonl_first_record=first_record,
                 phase11=c3_walls)
            for name in MAIN_KERNELS if run == "first" else ():
                require(launches.get(name, 0) > 0,
                        f"cli config 3: {name} never launched")
            require(first_record == "meta", "cli config 3: JSONL meta line")
            require(f64 <= tol, f"cli config 3 ({run}): snapshot f64 {f64}")
            require(out.get("certified", out["converged"])
                    and out.get("certified_rel_gap", f64) <= tol,
                    f"cli config 3 ({run}): not certified: {out}")
        require(sweeps["resume"] < sweeps["first"],
                f"cli config 3: resumed in {sweeps['resume']} sweeps, first "
                f"run {sweeps['first']}")

    with captured(lp_mod, "lambda_path") as calls:
        out, launches, wall = run_cli(FRONT_C2)
    (args, _, res), = calls
    f64 = certify(args[0], res, tol)
    conv = res.converged.cpu().tolist()
    del calls, args, res
    line(f"cli_config2_lambda_path_{C2_LEN}pt_fista_{C2_M}x{C2_N}", out,
         launches, wall, f64_rel_gap=f64, converged=conv,
         phase7_fista_wall_s=c2_fista_wall)
    require(out["mode"] == "lambda_path" and len(out["path"]) == C2_LEN,
            "cli config 2: path rows")
    for name in ("ax_minus_b_t", "neg_at_r_t"):
        require(launches.get(name, 0) > 0, f"cli config 2: {name}")
    bad = [g for g, c in zip(f64, conv) if c and g > C2_F32_FLOOR]
    require(not bad, f"cli config 2: converged points with f64 gaps {bad}")
    torch.cuda.empty_cache()

    out, launches, wall = run_cli(["--config", "config1", "--cv", "3"])
    line("cli_config1_cv3_500x2000", out, launches, wall)
    require(out["mode"] == "cv" and out["k"] == 3
            and all(math.isfinite(v) for v in out["mean_mse"]),
            "cli config 1 CV")
    require(launches.get("batch_sweep_t", 0) > 0, "cli CV: K5")

    out, launches, wall = run_cli(["--config", "config4", "--ci"])
    line("cli_config4_ci", out, launches, wall)
    require(math.isfinite(out["rel_gap"]) and out["n"] == 512,
            "cli config 4 (CI)")
    for name in ("ax_minus_b_t", "neg_at_r_t"):
        require(launches.get(name, 0) > 0, f"cli config 4 (CI): {name}")

    out, launches, wall = run_cli(["--config", "config5", "--ci", "--mesh",
                                   "1", "--method", "bcd_pallas"])
    line("cli_config5_ci_mesh1_nccl", out, launches, wall)
    require(out["method"] == "sharded_bcd" and math.isfinite(out["rel_gap"]),
            "cli config 5 (CI, mesh 1)")
    require(launches.get("sweep_slab_t", 0) > 0
            and launches.get("sweep_t", 0) == 0,
            f"cli config 5 (mesh 1): K8 and not K1, got {launches}")


def small_path_runs(run: dict) -> list:
    """One path run of ``sharded_paths_job`` as ``path_check`` reads it:
    per point its gathered x, its checks' ``primal`` and ``rel_gap``, and
    whether it converged."""
    return [dict(x=run["xs"][l], primal=run["histories"][l]["primal"],
                 rel_gap=run["histories"][l]["rel_gap"],
                 converged=bool(run["converged"][l]))
            for l in range(len(run["xs"]))]


def sharded_paths_job(g, A_s, b_s, pens_s, c3, c2) -> dict:
    """Phase 17 in each of the SHARD_P ranks (gloo, sharing the card).
    The small instance (SHARD_SMALL; ``pens_s`` its penalties): the
    screened sharded BCD, the sequential bcd_pallas and fista paths and
    the batched path, on the card and on the CPU (plain versions); then
    config 3 screened (``c3``: A from shared memory, b, lam1, lam2) and
    config 2's bcd_batch and fista paths (``c2``: A, b) at full width."""
    import dataclasses

    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.problem import (
        Problem,
        problem_from_numpy,
    )
    from convex_optimization_tpu_torch.models.penalties import l1, nonneg_l1
    from convex_optimization_tpu_torch.ops import _build
    from convex_optimization_tpu_torch.solvers.common import SolverConfig

    def sync():
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)

    def path_out(pr, wall):
        return dict(xs=pr.xs.cpu().numpy(), lambdas=pr.lambdas.tolist(),
                    gaps=pr.gaps.tolist(), iters=pr.iters.tolist(),
                    converged=pr.converged.tolist(), sweeps=pr.sweeps,
                    method_used=pr.method_used, wall=wall,
                    histories=[{k: v.tolist() for k, v in h.items()}
                               for h in pr.histories],
                    launches=dict(_build.launches))

    cpu = dataclasses.replace(g, device=torch.device("cpu"))
    small = {}
    for where, gg in (("card", g), ("cpu", cpu)):
        for kind, pen in pens_s.items():
            p = problem_from_numpy(A_s, b_s, device="cpu", **pen)
            _build.reset_launches()
            res = cot.solve(p, "bcd_pallas", mesh=gg, **SHARD_SCREEN)
            small[(where, "screened", kind)] = dict(
                x=res.x.cpu().numpy(), k=res.iterations,
                screened=res.screened, converged=bool(res.converged),
                primal=res.history["primal"].tolist(),
                rel_gap=res.history["rel_gap"].tolist(),
                launches=dict(_build.launches))
            for method, kw in SMALL_PATHS:
                _build.reset_launches()
                t0 = time.perf_counter()
                pr = cot.lambda_path(p, SolverConfig(**kw), mesh=gg,
                                     method=method, **SMALL_GRID)
                small[(where, method, kind)] = path_out(
                    pr, time.perf_counter() - t0)

    # config 3 at full width, screened, then config 2's paths
    A3, b3, lam3, lam2 = c3
    p3 = Problem(A_t=A3.unsqueeze(1), b=b3, penalty=nonneg_l1(lam3),
                 lam2=lam2)
    sync()
    _build.reset_launches()
    res = cot.solve(p3, "bcd_pallas", mesh=g, **C3_SOLVE)
    sync()
    c3_out = dict(k=res.iterations, rel_gap=res.rel_gap,
                  wall=res.wall_time_s, setup=res.setup_time_s,
                  screened=res.screened, launches=dict(_build.launches),
                  x=res.x.cpu().numpy() if g.rank == 0 else None)
    del p3, res
    A2, b2 = c2
    p2 = Problem(A_t=A2.unsqueeze(1), b=b2, penalty=l1(1.0))
    c2_out = {}
    for method in ("bcd_batch", "fista"):
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        pr = cot.lambda_path(p2, SolverConfig(**C2_CFG), path_len=C2_LEN,
                             method=method, mesh=g)
        sync()
        c2_out[method] = path_out(pr, time.perf_counter() - t0)
        if g.rank != 0:
            c2_out[method]["xs"] = None
    return dict(small=small, c3=c3_out, c2=c2_out)


def sharded_paths_phase(device, c3_host: dict, c2_xs: dict, gpu: str,
                        power: str, stats: dict) -> dict:
    """Phase 17: gap-safe screening and the lambda paths on the column
    layout, SHARD_P gloo ranks sharing the card (as phase 10).  Before
    the ranks, K5-K7 against their plain versions on a 64-block slice of
    a rank's config-2 slab at the width the sharded batched path picks
    (B = 40).  ``c3_host``: config 3's host arrays, lam1 and phase 11's
    screened count; ``c2_xs``: phase 7's xs by method.  Returns the
    ranks' launches summed over the full-width runs."""
    import tempfile

    import numpy as np
    import torch

    import convex_optimization_tpu_torch as cot
    from convex_optimization_tpu_torch.core.datagen import (
        make_lasso_instance_host,
    )
    from convex_optimization_tpu_torch.parallel.launch import run_ranks
    from convex_optimization_tpu_torch.solvers.batched_path import (
        _shard_block,
    )

    inst2, A2_np, b2_np = make_lasso_instance_host(C2_SEED, C2_M, C2_N,
                                                   device="cpu")
    B2 = _shard_block(C2_N, 80, 1, SHARD_P)[0]
    require(B2 == 40, f"config 2's sharded batched width {B2}")
    slab = inst2.problem.with_block(B2).A_t[:C2_N // B2 // SHARD_P]
    compare_batch_kernels(slab[:64].to(device), inst2.problem.b.to(device),
                          "config2_slab40", stats, False, (gpu, power))

    A_s, b_s, pens_s = shard_small_instance()
    A3 = torch.from_numpy(np.ascontiguousarray(c3_host["A"].T)) \
        .share_memory_()
    A2 = torch.from_numpy(np.ascontiguousarray(A2_np.T)).share_memory_()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(
            sharded_paths_job, SHARD_P, tmp, A_s, b_s, pens_s,
            (A3, torch.from_numpy(c3_host["b"]), c3_host["lam1"], C3_LAM2),
            (A2, torch.from_numpy(b2_np)), device=str(device),
            backend="gloo", timeout_s=1000, collective_timeout_s=300)
    ranks_s = time.perf_counter() - t0
    del A3, A2
    r0 = ranks[0]

    # the small runs: each card run held to the CPU run of the same input
    # by path_check, per point for the paths
    probs = {k: cot.problem_from_numpy(A_s, b_s, device="cpu", **pen)
             for k, pen in pens_s.items()}
    small = {}
    for kind, p in probs.items():
        runs = {w: r0["small"][(w, "screened", kind)] for w in ("card",
                                                                 "cpu")}
        pol = {w: path_run(p, run, A_s, b_s, 1e-6) for w, run in
               runs.items()}
        fails = path_check(pol["card"], pol["cpu"], SHARD_SCREEN["tol"],
                           SHARD_SCREEN["gap_every"])
        require(not fails, f"sharded screened {kind}: {'; '.join(fails)}")
        for rank in ranks:
            lc = rank["small"][("card", "screened", kind)]["launches"]
            require(lc.get("sweep_slab_t", 0) > 0
                    and lc.get("sweep_t", 0) == 0,
                    f"sharded screened {kind}: launches {lc}")
        require(0 < runs["card"]["screened"] < p.n,
                f"sharded screened {kind}: {runs['card']['screened']} "
                "columns screened")
        small[f"screened/{kind}"] = dict(
            k=[runs[w]["k"] for w in ("card", "cpu")],
            screened=[runs[w]["screened"] for w in ("card", "cpu")],
            path=path_numbers(pol["card"], pol["cpu"], SHARD_SCREEN["tol"]))
        for method, kw in SMALL_PATHS:
            card, cpu = (r0["small"][(w, method, kind)]
                         for w in ("card", "cpu"))
            want = f"{method}+sharded"
            require(card["method_used"] == cpu["method_used"] == want,
                    f"small {method} {kind} path ran {card['method_used']}"
                    f" / {cpu['method_used']}")
            np.testing.assert_allclose(card["lambdas"], cpu["lambdas"],
                                       rtol=1e-5)
            pts = []
            for l, (pc, ph) in enumerate(zip(small_path_runs(card),
                                             small_path_runs(cpu))):
                # each run polished at its own grid point
                a = path_run(p.with_lam1(card["lambdas"][l]), pc, A_s, b_s,
                             1e-6)
                h = path_run(p.with_lam1(cpu["lambdas"][l]), ph, A_s, b_s,
                             1e-6)
                fails = path_check(a, h, kw["tol"], kw["gap_every"])
                require(not fails, f"small {method} {kind} path point {l}"
                        f": {'; '.join(fails)}")
                pts.append(path_numbers(a, h, kw["tol"]))
            small[f"{method}/{kind}"] = dict(
                sweeps=[card["sweeps"], cpu["sweeps"]],
                iters=[card["iters"], cpu["iters"]], points=pts)
    log(f"# sharded small paths {SHARD_SMALL[1]}x{SHARD_SMALL[2]} "
        f"P={SHARD_P}, card against CPU: {json.dumps(small)}")

    # config 3 at full width, screened, polished here
    c3 = r0["c3"]
    for rank in ranks:
        lc = rank["c3"]["launches"]
        require(lc.get("sweep_slab_t", 0) > 0 and lc.get("sweep_t", 0) == 0
                and lc.get("neg_at_r_t", 0) > 0
                and lc.get("block_power_t", 0) > 0,
                f"sharded config 3 launches {lc}")
        require(rank["c3"]["k"] == c3["k"], "ranks disagree on steps")
    x3 = c3["x"]
    require(x3.shape == (N,) and bool(np.isfinite(x3).all())
            and bool((x3 >= 0).all()), "sharded config 3 x")
    require(0 < c3["screened"] < N,
            f"sharded config 3: {c3['screened']} columns screened")
    p3 = cot.problem_from_numpy(c3_host["A"], c3_host["b"], "nonneg_l1",
                                c3_host["lam1"], lam2=C3_LAM2, device="cpu")
    pr = cot.polish_support(p3, torch.from_numpy(x3), tol=C3_SOLVE["tol"],
                            A_host=c3_host["A"], b_host=c3_host["b"])
    del p3
    print(json.dumps({
        "metric": f"sharded_config3_time_to_certified_1e-06_rel_gap_"
                  f"nonneg_en_{M}x{N}_screened_{SHARD_P}ranks_1card",
        "sweeps": c3["k"],
        "screened_at_last_check": c3["screened"],
        "phase11_screened": c3_host["screened"],
        "solve_wall_s": c3["wall"],
        "polish_wall_s": pr.wall_time_s,
        "total_s": c3["wall"] + pr.wall_time_s,
        "ms_per_step": 1e3 * c3["wall"] / max(c3["k"], 1),
        "k4_setup_s": c3["setup"],
        "phase11_sweeps": c3_host["sweeps"],
        "phase11_solve_wall_s": c3_host["solve_wall_s"],
        "f32_rel_gap": c3["rel_gap"],
        "f64_rel_gap": pr.rel_gap,
        "nnz": int(np.count_nonzero(pr.x)),
        "launches_per_rank": [r["c3"]["launches"] for r in ranks],
        "gpu": gpu,
        "power_limit": power,
    }), flush=True)
    require(pr.rel_gap <= C3_SOLVE["tol"],
            f"sharded config 3: f64 certificate {pr.rel_gap}")

    # config 2's paths at full width: every converged point <= the f32
    # floor in f64, beside phase 7's
    p2 = cot.problem_from_numpy(A2_np, b2_np, "l1", 1.0, device=device)
    for method, want_kernels in (
            ("bcd_batch", PATH_KERNELS + ("neg_at_r_t",)),
            ("fista", ("ax_minus_b_t", "neg_at_r_t"))):
        run = r0["c2"][method]
        require(run["method_used"] == f"{method}+sharded",
                f"sharded config 2 {method} path ran {run['method_used']}")
        for rank in ranks:
            lc = rank["c2"][method]["launches"]
            for name in want_kernels:
                require(lc.get(name, 0) > 0,
                        f"sharded config 2 {method}: {name} launches {lc}")
            if method == "bcd_batch":
                require(lc.get("batch_sweep_t", 0) == run["sweeps"],
                        f"sharded config 2: K5 launches {lc} for "
                        f"{run['sweeps']} sweeps")
        xs = torch.from_numpy(run["xs"])
        require(tuple(xs.shape) == (C2_LEN, C2_N)
                and bool(torch.isfinite(xs).all()),
                f"sharded config 2 {method} xs")
        f64 = [float(cot.duality_gap(p2.with_lam1(lam), xs[l].to(device),
                                     precise=True).rel_gap)
               for l, lam in enumerate(run["lambdas"])]
        bad = [gp for gp, c in zip(f64, run["converged"])
               if c and gp > C2_F32_FLOOR]
        dx = [float((xs[l] - c2_xs[method]["xs"][l]).abs().max())
              for l in range(C2_LEN)]
        print(json.dumps({
            "metric": f"sharded_config2_lambda_path_{C2_LEN}pt_{method}_"
                      f"{C2_M}x{C2_N}_{SHARD_P}ranks_1card",
            "sweeps": run["sweeps"],
            "iters": run["iters"],
            "wall_s": run["wall"],
            "ms_per_sweep": 1e3 * run["wall"] / max(run["sweeps"], 1),
            "phase7_sweeps": c2_xs[method]["sweeps"],
            "phase7_wall_s": c2_xs[method]["wall"],
            "converged": run["converged"],
            "returned_rel_gap": run["gaps"],
            "f64_rel_gap": f64,
            "max_abs_dx_vs_phase7": max(dx),
            "dx_vs_phase7": dx,
            "launches_per_rank": [r["c2"][method]["launches"]
                                  for r in ranks],
            "gpu": gpu,
            "power_limit": power,
        }), flush=True)
        require(not bad, f"sharded config 2 {method}: converged points with "
                f"f64 gaps {bad}")
        require(any(run["converged"]),
                f"sharded config 2 {method}: no point converged")
    del p2
    torch.cuda.empty_cache()
    log(f"# phase 17 ranks wall {ranks_s:.1f} s")
    total: dict = {}
    for rank in ranks:
        for lc in [rank["c3"]["launches"]] + [rank["c2"][m]["launches"]
                                              for m in rank["c2"]]:
            for name, n in lc.items():
                total[name] = total.get(name, 0) + n
    return total


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
    card2 = (gpu_name, power_limit)
    compare_kernels(A_small.view(32, 32, 256), b_small, x_small, keep_small,
                    "small", stats, False, card2)

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
                    "slice", stats, False, card2)
    compare_kernels(A_t80, problem.b, x_dense,
                    torch.ones(N, dtype=torch.bool, device=device), "full",
                    stats, True, card2)
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
    main_walls = dict(solve_wall_s=res.wall_time_s,
                      polish_wall_s=pr.wall_time_s,
                      total_s=res.wall_time_s + pr.wall_time_s)
    # phase 16 polishes the same f32 x and holds them to this support
    x_head, head_support = res.x.clone(), pr.x != 0
    # the headline instance stays for phases 9, 10, 12 and 13
    del res, pr, A_t80

    # 5. batched kernels vs plain versions, and K2 and K3 on config 2's A_t
    compare_batch_kernels(A_small.view(32, 32, 256), b_small, "small", stats,
                          False, card2)
    t0 = time.perf_counter()
    inst2, _, _ = make_lasso_instance_host(C2_SEED, C2_M, C2_N,
                                           device=device)
    torch.cuda.synchronize()
    log(f"# datagen {C2_M}x{C2_N}: {time.perf_counter() - t0:.2f} s")
    p2 = inst2.problem
    by_L = compare_batch_kernels(p2.with_block(80).A_t, p2.b, "config2",
                                 stats, True, card2)
    c2_matvec = compare_matvecs(p2.with_block(80).A_t, p2.b,
                                torch.randn(C2_N, generator=gen).to(device),
                                "config2", stats, True, card2, main=False)
    nb2 = C2_N // 80
    print(json.dumps({
        "metric": f"k5_ms_per_sweep_by_L_{C2_M}x{C2_N}_B80",
        "k5_ms": {str(k): v for k, v in by_L.items() if k != "k1"},
        "k5_us_per_block": {str(k): 1e3 * v / nb2 for k, v in by_L.items()
                            if k != "k1"},
        "k5_plan": {str(k): k5_plan(device, 80, C2_M, k) for k in by_L
                    if k != "k1"},
        "k1_ms": by_L["k1"],
        "k5_ms_per_point": {str(k): v / k for k, v in by_L.items()
                            if k != "k1"},
        "gpu": gpu_name, "power_limit": power_limit}), flush=True)

    # 6. small path reference, card against CPU
    small_path_reference(device)

    # 7. config 2: the lambda path, then K-fold CV
    path_launches, c2_wall, c2_batch = config2_path(p2, gpu_name,
                                                    power_limit, stats)
    c2_fista = config2_fista_path(p2, gpu_name, power_limit, c2_wall,
                                  c2_matvec)
    c2_fista_wall = c2_fista["wall"]
    config2_cv(p2, gpu_name, power_limit, stats)
    del p2, inst2
    torch.cuda.empty_cache()

    # 8. config 4: group K1 and K9, both routes certified
    # a small shape first: 128 groups of 16 with random weights in
    # [0.5, 1.5), blocks of 2 groups (K1) and of 16 (K9), a partly-zero mask
    small = torch.randn(2048, 512, generator=gen)
    small /= torch.linalg.vector_norm(small, dim=1, keepdim=True)
    b_g = torch.randn(512, generator=gen).to(device)
    w_g = 0.5 + torch.rand(128, generator=gen).to(device)
    compare_group_sweeps(
        small.to(device), b_g, 0.1 * float(b_g.norm()), 16, w_g,
        (torch.rand(2048, generator=gen) > 0.1).to(device),
        {"sweep_t": 32, "sweep_tiled_t": 256}, "small", stats, timed=False)
    compare_group_batch(small.to(device), b_g, 16, w_g, 32, "small", stats,
                        False, card2)
    small_group_reference(device)
    small_group_cv(device)
    compare_tall_k9(device, stats, gpu_name, power_limit)
    k9_launches = config4(device, gpu_name, power_limit, stats)
    torch.cuda.empty_cache()

    # 9. K8 against its plain version: small shapes (weighted group_l2
    # with a partly-zero mask, nonneg_l1), then rank 0's slab of the
    # headline at P = 2 (625 x 80 x 10000): a 64-block slice and the whole
    small = torch.randn(2048, 512, generator=gen)
    small /= torch.linalg.vector_norm(small, dim=1, keepdim=True)
    small_t = small.to(device).view(64, 32, 512)
    b_s = torch.randn(512, generator=gen).to(device)
    w_s = 0.5 + torch.rand(128, generator=gen).to(device)
    keep_s = (torch.rand(2048, generator=gen) > 0.1).to(device)
    lam_s = 0.1 * float(b_s.norm())
    compare_slab(small_t, b_s, cot.group_l2(lam_s, 128, w_s), keep_s,
                 "small", stats, timed=False)
    compare_slab(small_t, b_s, cot.nonneg_l1(0.2 * lam_s), keep_s, "small",
                 stats, timed=False)
    slab = problem.A_t.view(N // 80, 80, M)[:N // 80 // SHARD_P]
    keep_part = (torch.rand(64 * 80, generator=gen) > 0.1).to(device)
    compare_slab(slab[:64], problem.b, problem.penalty, keep_part, "slice",
                 stats, timed=False)
    compare_slab(slab, problem.b, problem.penalty, None, "slab", stats,
                 timed=True)
    del slab

    # 10. the column-sharded path: SHARD_P ranks on the card, the NCCL
    # world-size-1 group, single-device FISTA
    slab_launches = sharded_phase(device, problem, A_np, b_np, gpu_name,
                                  power_limit)

    # 11. config 3: nonneg elastic net with gap-safe screening, certified
    c3 = config3(device, gpu_name, power_limit)
    c3_walls = {k: c3[k] for k in ("sweeps", "solve_wall_s",
                                   "polish_wall_s")}

    # 12. the working-set solvers at the headline
    ws_headline(problem, A_np, b_np, gpu_name, power_limit, main_walls)
    # 13. ADMM: the headline with the host set-up, then the device set-up
    # card against CPU under the fence
    admm_headline(problem, A_np, b_np, gpu_name, power_limit)
    # 16 (first part). polish and polish_fast at phase 4's f32 x
    headline_polishes(problem, x_head, A_np, b_np, head_support,
                      main_walls["polish_wall_s"], gpu_name, power_limit)
    del problem, inst, A_np, b_np
    torch.cuda.empty_cache()
    admm_small(device, gpu_name, power_limit)

    # 14. config 2's compacting, working-set and ADMM paths
    config2_new_paths(device, gpu_name, power_limit, c2_wall, c2_fista_wall)

    # 15. the group working set, card against CPU
    group_ws_reference(device, gpu_name, power_limit)

    # 16. the front door: the CLI on the card
    torch.cuda.empty_cache()
    front_door(device, gpu_name, power_limit, c3_walls, c2_fista_wall)

    # 17. screening and the lambda paths on the column layout: SHARD_P
    # ranks on the card, config 3 and config 2 at full width
    torch.cuda.empty_cache()
    shard_path_launches = sharded_paths_phase(
        device, c3, {"bcd_batch": c2_batch, "fista": c2_fista},
        gpu_name, power_limit, stats)
    del c3

    require(all(math.isfinite(stats[k]["ms"]) for k in KERNELS),
            "kernel times")
    log(f"# chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    kernel_launches = {k: launches[k] for k in MAIN_KERNELS}
    kernel_launches.update({k: path_launches[k] for k in KERNELS
                            if k not in MAIN_KERNELS + ("sweep_tiled_t",
                                                        "sweep_slab_t")})
    kernel_launches["sweep_tiled_t"] = k9_launches["sweep_tiled_t"]
    kernel_launches["sweep_slab_t"] = slab_launches
    # phase 17's ranks launched K2-K8 on their slabs
    for name in KERNELS:
        kernel_launches[name] += shard_path_launches.get(name, 0)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": kernel_launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
