"""K9: the streamed Gauss-Seidel sweep, for blocks too wide for K1's tile.

Counterpart of ``convex_optimization_tpu/ops/bcd_sweep_pallas_tiled.py``.
The kernel is ``csrc/sweep_tiled.cu`` (its note gives the design): the same
sweep as K1 over the same layout ``A_t`` (n/B, B, m), with each CTA's
(B x rows) slab streamed through a shared-memory ring of chunks instead of
held there: phase 1 reads the chunks in order, phase 2 walks them
backwards and re-reads only those the ring did not keep.  The TPU kernel's
block-major copy of A is not made: a coordinate's rows are already one
contiguous run in ``A_t``.

``sweep_tiled_t`` is the wrapper and ``sweep_tiled_t_plain`` its plain
PyTorch version (the same loop as K1's), which runs for CPU tensors and is
the kernel's oracle on the card.  ``tiled_tiling`` is the launch plan's
pure part and ``tiled_schedule`` the order in which the kernel loads and
uses a CTA's chunks.  ``ops.bcd_sweep.sweep_route`` says which of K1 and
K9 takes a block.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from convex_optimization_tpu_torch.models.penalties import Penalty
from convex_optimization_tpu_torch.ops import _build
from convex_optimization_tpu_torch.ops.bcd_sweep import (
    KIND_CODE,
    MAX_SMEM_BYTES,
    _check_operands,
    group_operands,
    sweep_t_plain,
    up4,
)
from convex_optimization_tpu_torch.ops.matvec import _aligned

#: K9's threads per CTA (csrc/sweep_tiled.cu kThreads): one producer warp
#: and K9_CONS consumer threads (kCons), K9_CONS_WARPS warps
K9_THREADS = 384
K9_CONS_WARPS = K9_THREADS // 32 - 1
K9_CONS = 32 * K9_CONS_WARPS
#: the bytes of a CTA's chunk the plan aims at
K9_CHUNK_BYTES = 64 * 1024
#: the most segments phase 2 is split into
K9_MAX_S2 = 16

#: (device index, B, m, A_t aligned) -> K9's TiledPlan
_plan_cache: dict = {}


def sweep_tiled_t_plain(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                        steps: torch.Tensor, keep_mask: torch.Tensor | None,
                        penalty: Penalty, lam2: float,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: the same sweep as K1's, block by block."""
    return sweep_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """K9's launch at one (B, m): ``grid`` CTAs of ``rows`` rows each; a
    coordinate's rows at stride ``ld`` floats in shared memory (a multiple
    of 4: every run is one bulk copy of the 16-byte granules that hold it);
    ``vec``: the float4 instance (m % 4 == 0, A_t 16-byte aligned,
    rows % 4 == 0, ld % 8 == 4); a ring of ``slots``
    chunks of ``chunk`` coordinates, of which phase 2 finds the last
    ``kept`` chunks of phase 1 still there; ``s1``: the lanes (a power of
    two) that split a phase-1 unit's rows; ``s2``: the segments phase 2
    splits a chunk's coordinates into; ``rw``: the warps that split each
    reduced coordinate's G partials (the 11 consumer warps, or 1 with no
    shared scratch).
    The group scales' region holds B floats, enough for every group width
    that divides B."""
    B: int
    grid: int
    rows: int
    ld: int
    vec: bool
    chunk: int
    slots: int
    kept: int
    s1: int
    s2: int
    rw: int

    @property
    def n_chunks(self) -> int:
        return -(-self.B // self.chunk)

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the layout (csrc/sweep_tiled.cu ``layout``)."""
        return 4 * _layout_floats(self.B, self.rows, self.ld, self.chunk,
                                  self.slots, self.s2, self.rw, self.vec)


def _layout_floats(B: int, rows: int, ld: int, C: int, S: int, S2: int,
                   RW: int, vec: bool) -> int:
    bar = (S * C * ld + up4(rows, vec) + 2 * up4(B, vec)
           + up4((S2 - 1) * rows, vec) + (32 * RW if RW > 1 else 0))
    return bar + (bar & 1) + 4 * S


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def tiled_tiling(B: int, m: int, sms: int,
                 smem_limit: int = MAX_SMEM_BYTES,
                 aligned: bool = True) -> TiledPlan | None:
    """The pure part of ``tiled_plan``: K9's plan on a card of ``sms`` SMs
    with ``smem_limit`` bytes of shared memory per CTA, for an A_t that is
    16-byte ``aligned`` or not, or None when not even one coordinate's run
    fits beside the CTA's r.

    One CTA per SM (at most m), rows = ceil(m / grid); the float4 instance
    (when m % 4 == 0 and A_t is aligned) rounds rows up to 4 and pads ld
    to 4 mod 8; the scalar instance's ld holds a run 0-3 floats into its
    row (rows + 3 rounded up to 4, and to 4 mod 8).  Chunks of about K9_CHUNK_BYTES (whole coordinates, at most B);
    the ring takes as many slots as the shared memory left holds, up to
    the block's chunks plus one.  One slot stays free for the load that
    crosses the barriers and the rest hold phase 1's last chunks for
    phase 2 (all of them where the block fits).  Phase 1 units of two
    coordinates take the most lanes (a power of two, at most 32) that let
    one pass of the K9_CONS consumer threads cover a chunk; phase 2 splits
    into segments up to K9_CONS threads, at most K9_MAX_S2 and the chunk's
    coordinates; the reduction's 11 consumer warps share an (11, 32)
    scratch, or 1 and 1 warp where that does not fit.
    The last resort (scalar, unsplit, one slot of one coordinate, ld =
    rows + 3 rounded up to 4) takes no more shared memory than the first
    design's smallest ring (three one-coordinate slots) where rows >= 6,
    so every (B, m) that took a plan then takes one now."""
    G0 = min(sms, m)
    rows0 = -(-m // G0)
    cands = []
    def pad_ld(v):
        v = up4(v, True)
        return v if v % 8 == 4 else v + 4

    for vec in ((True, False) if m % 4 == 0 and aligned else (False,)):
        rows = up4(rows0, vec)
        ld = pad_ld(rows if vec else rows + 3)
        q = rows // 4 if vec else rows
        s2 = max(1, min(K9_MAX_S2, K9_CONS // q))
        cands += [(vec, rows, ld, s2, K9_CONS_WARPS), (vec, rows, ld, 1, 1)]
    cands.append((False, rows0, up4(rows0 + 3, True), 1, 1))  # last resort
    limit = smem_limit // 4
    for vec, rows, ld, s2, rw in cands:
        chunk = max(1, min(B, round(K9_CHUNK_BYTES / (4 * ld))))

        def floats(C, S):
            return _layout_floats(B, rows, ld, C, S, min(s2, C), rw, vec)

        while chunk > 1 and floats(chunk, 1) > limit:
            chunk -= 1
        if floats(chunk, 1) > limit:
            continue
        n_chunks = -(-B // chunk)
        slots = 1
        while slots <= n_chunks and floats(chunk, slots + 1) <= limit:
            slots += 1
        hp = -(-chunk // 2)
        nk = rows // 4 if vec else rows
        s1 = min(32, _pow2_floor(K9_CONS // hp),
                 1 << max(0, nk - 1).bit_length())
        return TiledPlan(B, -(-m // rows), rows, ld, vec, chunk, slots,
                         min(n_chunks, slots - 1), s1,
                         min(s2, chunk), rw)
    return None


def tiled_schedule(n_chunks: int, slots: int, kept: int,
                   n_blocks: int = 2) -> list[tuple]:
    """The order in which one CTA of K9 loads and uses its chunks over
    ``n_blocks`` blocks (csrc/sweep_tiled.cu mirrors it), as events:

      ("load", block, phase, chunk, slot): a copy issued into ``slot``;
      ("use", block, phase, chunk, slot): a phase reads the chunk there;
      ("barriers", block): between the block's phase 1 and phase 2.

    A block's loads are phase 1's chunks 0 .. N-1, then phase 2's
    N-K-1 .. 0 (the last K of phase 1 are still in the ring); load t goes
    to slot t mod S.  Phase 2 uses N-1 .. 0.  Before each use, and after
    phase 1, every load whose slot's previous chunk has had its last use
    is issued, in order."""
    N, S, K = n_chunks, slots, kept
    LB = 2 * N - K
    total = n_blocks * LB

    def load(t):
        j, l = divmod(t, LB)
        return ("load", j, 1 if l < N else 2,
                l if l < N else 2 * N - K - 1 - l, t % S)

    def last_use(t):
        j, l = divmod(t, LB)
        return j * 2 * N + (l if l < N - K else
                            2 * N - 1 - l if l < N else l + K)

    events, nxt = [], 0

    def refill(U):
        nonlocal nxt
        while nxt < total and (nxt < S or last_use(nxt - S) < U):
            events.append(load(nxt))
            nxt += 1

    for j in range(n_blocks):
        for k in range(N):
            refill(j * 2 * N + k)
            events.append(("use", j, 1, k, (j * LB + k) % S))
        events.append(("barriers", j))
        refill(j * 2 * N + N)
        for p in range(N):
            t = j * LB + (N - 1 - p if p < K else N + p - K)
            refill(j * 2 * N + N + p)
            events.append(("use", j, 2, N - 1 - p, t % S))
    return events


def tiled_plan(device: torch.device, B: int, m: int,
               aligned: bool = True) -> TiledPlan:
    """K9's plan at (B, m) on ``device`` for an A_t that is 16-byte
    ``aligned`` or not: the SM count from torch, the tiling from
    ``tiled_tiling``, checked on the C side
    (``cot_sweep_tiled_check``: the same shared-memory bytes, and one CTA
    per SM co-resident for the cooperative launch).  Raises when not even
    one coordinate's run fits in shared memory."""
    key = (device.index, B, m, aligned)
    if key not in _plan_cache:
        props = torch.cuda.get_device_properties(device)
        limit = min(MAX_SMEM_BYTES,
                    getattr(props, "shared_memory_per_block_optin",
                            MAX_SMEM_BYTES))
        plan = tiled_tiling(B, m, props.multi_processor_count, limit,
                            aligned)
        if plan is None:
            raise ValueError(f"K9 ring of B={B} x m={m} does not fit in "
                             "shared memory")
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            _build.check(_build.load().cot_sweep_tiled_check(
                B, plan.rows, plan.ld, plan.chunk, plan.slots, plan.s2,
                plan.rw, int(plan.vec), out), "cot_sweep_tiled_check")
        if out[0] != plan.smem_bytes:
            raise RuntimeError(f"K9 layout: C side {out[0]} bytes, plan "
                               f"{plan.smem_bytes}")
        if out[1] < 1:
            raise RuntimeError(f"K9 plan {plan} fits no SM")
        _plan_cache[key] = plan
    return _plan_cache[key]


def sweep_tiled_t(A_t: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                  steps: torch.Tensor, keep_mask: torch.Tensor | None,
                  penalty: Penalty, lam2: float,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cyclic sweep, A streamed; returns new (x, r).

    Operands as ``ops.bcd_sweep.sweep_t``: A_t (n_blocks, B, m) f32; x (n,),
    r (m,) = A x - b, steps (n_blocks,) t_j = step_scale / (L_j + lam2);
    keep_mask None or (n,) bool; a group_l2 block holds whole groups.  CPU
    tensors take the plain version; CUDA tensors launch K9 or raise."""
    if A_t.device.type == "cpu":
        return sweep_tiled_t_plain(A_t, x, r, steps, keep_mask, penalty, lam2)
    if A_t.device.type != "cuda":
        raise ValueError(f"unsupported device {A_t.device}")
    if penalty.kind not in KIND_CODE:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
    _check_operands(A_t, x, r, steps, keep_mask)
    nb, B, m = A_t.shape
    dev = A_t.device
    gsize, w = group_operands(penalty, nb * B, B, dev)
    plan = tiled_plan(dev, B, m, _aligned(A_t))
    x_out = torch.empty_like(x)
    r_out = torch.empty_like(r)
    partials = torch.empty(((plan.grid + 1) * B,), dtype=torch.float32,
                           device=dev)
    bar = torch.zeros((1,), dtype=torch.int32, device=dev)  # grid barrier
    err = _build.load().cot_sweep_tiled_t(
        A_t.data_ptr(), x.data_ptr(), r.data_ptr(), steps.data_ptr(),
        None if keep_mask is None else keep_mask.data_ptr(),
        None if w is None else w.data_ptr(),
        x_out.data_ptr(), r_out.data_ptr(), partials.data_ptr(),
        bar.data_ptr(), nb, B, m, gsize, float(penalty.lam1), float(lam2),
        KIND_CODE[penalty.kind], plan.grid, plan.rows, plan.ld, plan.chunk,
        plan.slots, plan.kept, plan.s1, plan.s2, plan.rw, int(plan.vec),
        _build.stream_ptr(dev))
    _build.check(err, "sweep_tiled_t")
    _build.launches["sweep_tiled_t"] += 1
    return x_out, r_out
