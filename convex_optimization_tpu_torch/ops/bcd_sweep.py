"""K1: the fused Gauss-Seidel sweep over the transposed block-major layout.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_vpu.py``.  The
kernel is ``csrc/sweep.cu`` (its note gives the design); ``sweep_t`` is its
wrapper and ``sweep_t_plain`` its plain PyTorch version, which runs for
CPU tensors and is the kernel's oracle on the card.  K8, the column-sharded
solver's slab sweep (``ops/bcd_sweep_slab.py``), is the same kernel's
payload instance on the same plan (``launch``).

The TPU module's VMEM and 13 GiB HBM gates do not carry over: the H100's
limit is the kernel's shared-memory tile (B x ceil(m / SMs) floats).
``sweep_route`` states that limit as a pure function (the first design's
layout, which the launch plan ``sweep_tiling`` always falls back to); blocks
past it go to K9 (``ops/bcd_sweep_tiled.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep_ref import sweep_blocks
from convex_optimization_tpu_torch.ops.matvec import _aligned

KIND_CODE = {"l1": 0, "nonneg_l1": 1, "group_l2": 2}

#: shared memory one CTA may use on Hopper (csrc/sweep.cu kMaxSmemBytes)
MAX_SMEM_BYTES = 227 * 1024
#: SMs of an H100 SXM: how a CPU problem routes its blocks (``sweep_route``)
H100_SMS = 132
#: K1's threads per CTA (csrc/sweep.cu kThreads) and the most
#: segments a phase is split into
K1_THREADS = 384
K1_MAX_SEGMENTS = 8

#: (device index, B, m) -> K1's SweepPlan, None when no fit
_plan_cache: dict = {}


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


def k1_smem_bytes(B: int, m: int, sms: int) -> int:
    """K1's fit rule: the shared memory of one CTA of K1's first design at
    (B, m) on a card with ``sms`` SMs: the (B x rows) tile, the CTA's rows
    of r, dx, x_j and the group scales (B each).  The launch plan's last
    resort (``sweep_tiling``) needs no more, so the rule routes as it
    did."""
    rows = -(-m // min(sms, m))
    return 4 * (B * rows + rows + 3 * B)


def up4(v: int, vec: bool) -> int:
    """v rounded up to a multiple of 4 for the float4 instances."""
    return -(-v // 4) * 4 if vec else v


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """K1's launch at one (B, m): ``grid`` CTAs of ``rows`` rows each;
    tile rows of stride ``ld`` floats in shared memory; ``vec``: the float4 instance (m % 4 == 0, rows % 4 == 0, ld % 8 == 4),
    whose copies are 16 bytes when A_t is 16-byte aligned; ``prefetch``:
    the b-rows of tile j + 1 in flight across block j's barriers (B: a
    double buffer); ``s1``, ``s2``: the segments phase 1 and phase 2 are
    split into; ``rw``: the warps that split each reduced coordinate's G
    partials (all 12, or 1 with no shared scratch).  The group scales'
    region holds B floats, enough for every group width that divides B."""
    B: int
    grid: int
    rows: int
    ld: int
    vec: bool
    prefetch: int
    s1: int
    s2: int
    rw: int

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the layout (csrc/sweep.cu ``layout``)."""
        B, rows, vec = self.B, self.rows, self.vec
        red = max((self.s1 - 1) * 2 * -(-B // 2), (self.s2 - 1) * rows)
        floats = ((B + self.prefetch) * self.ld + up4(rows, vec)
                  + up4(B, vec) + up4(B, vec)    # dx, group scales
                  + up4(red, vec)
                  + (32 * self.rw if self.rw > 1 else 0))
        return 4 * floats


def sweep_tiling(B: int, m: int, sms: int,
                 smem_limit: int = MAX_SMEM_BYTES) -> SweepPlan | None:
    """The pure part of ``sweep_plan``: K1's plan on a card of ``sms`` SMs
    with ``smem_limit`` bytes of shared memory per CTA, or None when even
    the plainest layout does not fit.

    One CTA per SM (at most m), rows = ceil(m / grid); the float4 instance
    (when m % 4 == 0) rounds rows up to 4 and pads ld to 4 mod 8, else ld
    is odd (both keep phase 1's tile reads conflict-free).  Phase 1 (units
    of two tile rows) and phase 2 (units of 4 rows, or 1) split into
    segments up to K1_THREADS threads, at most K1_MAX_SEGMENTS, and the
    reduction's 12 warps share a (12, 32) scratch, or 1 and 1 warp where
    that scratch does not fit.  The spare shared memory then holds
    ``prefetch`` b-rows of the next tile, up to B.  The last resort
    (scalar, unsplit, ld = rows) takes no more shared memory than the first
    design's layout (``k1_smem_bytes``), so every (B, m) that
    ``sweep_route`` sends to K1 gets a plan."""
    G0 = min(sms, m)
    rows0 = -(-m // G0)
    cands = []
    for vec in ((True, False) if m % 4 == 0 else (False,)):
        rows = up4(rows0, vec)
        if vec:
            ld = rows if rows % 8 == 4 else rows + 4
        else:
            ld = rows | 1
        s1 = max(1, min(K1_MAX_SEGMENTS, K1_THREADS // -(-B // 2)))
        s2 = max(1, min(K1_MAX_SEGMENTS,
                        K1_THREADS // (rows // 4 if vec else rows), B))
        cands += [(vec, rows, ld, s1, s2, K1_THREADS // 32),
                  (vec, rows, ld, 1, 1, 1)]
    cands.append((False, rows0, rows0, 1, 1, 1))   # the first design's
    for vec, rows, ld, s1, s2, w in cands:
        plan = SweepPlan(B, -(-m // rows), rows, ld, vec, 0, s1, s2, w)
        spare = smem_limit - plan.smem_bytes
        if spare >= 0:
            return dataclasses.replace(
                plan, prefetch=min(B, spare // (4 * ld)))
    return None


def sweep_route(B: int, m: int, sms: int,
                smem_bytes: int = MAX_SMEM_BYTES) -> str:
    """Which sweep kernel runs a block of width B at m rows: ``"k1"`` where
    K1's tile fits in ``smem_bytes``, else ``"k9"`` (the streamed sweep).
    The JAX package's order is the same: the VMEM-resident kernel where it
    fits, the tiled one otherwise."""
    return "k1" if k1_smem_bytes(B, m, sms) <= smem_bytes else "k9"


def group_operands(penalty: Penalty, n: int, B: int, device,
                   ) -> tuple[int, torch.Tensor | None]:
    """(gsize, weights) as the sweep kernels read them: gsize 1 and no
    weights outside group_l2; for group_l2 the group width, which must
    divide B, and the (ngroups,) f32 weights on ``device`` or None."""
    if penalty.kind != "group_l2":
        return 1, None
    if n % penalty.ngroups or B % (n // penalty.ngroups):
        raise ValueError(f"block of {B} must hold whole groups "
                         f"(n={n}, ngroups={penalty.ngroups})")
    w = penalty.weights
    if w is not None:
        w = w.to(device=device, dtype=torch.float32).contiguous()
        if tuple(w.shape) != (penalty.ngroups,):
            raise ValueError(f"weights: expected ({penalty.ngroups},), got "
                             f"{tuple(w.shape)}")
    return n // penalty.ngroups, w


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


def sweep_plan(device: torch.device, B: int, m: int) -> SweepPlan:
    """K1's plan at (B, m) on ``device``: the SM count
    from torch, the tiling from ``sweep_tiling``, checked on the C side
    (``cot_sweep_check``: the same shared-memory bytes, and one CTA per SM
    co-resident for the cooperative launch).  Raises when the tile does not
    fit in shared memory (K9 takes those blocks, ``sweep_route``)."""
    key = (device.index, B, m)
    if key not in _plan_cache:
        props = torch.cuda.get_device_properties(device)
        limit = min(MAX_SMEM_BYTES,
                    getattr(props, "shared_memory_per_block_optin",
                            MAX_SMEM_BYTES))
        plan = sweep_tiling(B, m, props.multi_processor_count, limit)
        if plan is not None:
            out = (ctypes.c_int * 2)()
            with torch.cuda.device(device):
                _build.check(_build.load().cot_sweep_check(
                    B, plan.rows, plan.ld, plan.prefetch, plan.s1, plan.s2,
                    plan.rw, int(plan.vec), out),
                    "cot_sweep_check")
            if out[0] != plan.smem_bytes:
                raise RuntimeError(f"K1 layout: C side {out[0]} bytes, "
                                   f"plan {plan.smem_bytes}")
            if out[1] < 1:
                raise RuntimeError(f"K1 plan {plan} fits no SM")
        _plan_cache[key] = plan
    plan = _plan_cache[key]
    if plan is None:
        raise ValueError(f"sweep tile of B={B} x m={m} does not fit in "
                         "shared memory")
    return plan


def launch(name: str, A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
           steps: torch.Tensor, keep_mask: torch.Tensor | None,
           penalty: Penalty, lam2: float,
           payload: torch.Tensor | None = None,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/sweep.cu`` on CUDA tensors, on K1's plan: K1
    (``cot_sweep_t``), or K8 (``cot_sweep_slab_t``) where ``payload`` (m + 3
    floats) is given; adds one to ``launches[name]``.  Returns (x, r)."""
    if penalty.kind not in KIND_CODE:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
    _check_operands(A_t, x, r, steps, keep_mask)
    nb, B, m = A_t.shape
    dev = A_t.device
    gsize, w = group_operands(penalty, nb * B, B, dev)
    plan = sweep_plan(dev, B, m)
    # the tile's copies: 16-byte cp.async (the float4 instance on an
    # aligned A_t), else 4-byte cp.async
    copy = 1 if plan.vec and _aligned(A_t) else 0
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    partials = torch.empty(((plan.grid + 1) * B,), dtype=torch.float32,
                           device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)  # grid barrier
    lib = _build.load()
    head = (A_t.data_ptr(), x.data_ptr(), r.data_ptr(), steps.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(),
            None if w is None else w.data_ptr(),
            x_out.data_ptr(), r_out.data_ptr())
    tail = (partials.data_ptr(), bar.data_ptr(), nb, B, m, gsize,
            float(penalty.lam1), float(lam2), KIND_CODE[penalty.kind],
            plan.grid, plan.rows, plan.ld, plan.prefetch, plan.s1, plan.s2,
            plan.rw, int(plan.vec), copy, _build.stream_ptr(dev))
    if payload is None:
        err = lib.cot_sweep_t(*head, *tail)
    else:
        err = lib.cot_sweep_slab_t(*head, payload.data_ptr(), *tail)
    _build.check(err, name)
    _build.launches[name] += 1
    return x_out, r_out


def sweep_t(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
            steps: torch.Tensor, keep_mask: torch.Tensor | None,
            penalty: Penalty, lam2: float,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cyclic sweep; returns new (x, r).

    A_t (n_blocks, B, m) f32; x (n,), r (m,) = A x - b, steps (n_blocks,)
    the per-block steps t_j = step_scale / (L_j + lam2), all f32;
    keep_mask None or (n,) bool; a group_l2 block holds whole groups.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (a tile that does not fit in shared memory raises: K9 takes
    those blocks, ``sweep_route``)."""
    if A_t.device.type == "cpu":
        return sweep_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    return launch("sweep_t", A_t, x, r, steps, keep_mask, penalty, lam2)


def block_steps(block_L: torch.Tensor, lam2: float,
                step_scale: float = 1.0) -> torch.Tensor:
    """t_j = step_scale / (L_j + lam2), f32 as the kernel reads it."""
    return (step_scale / (block_L + lam2)).to(torch.float32).contiguous()

