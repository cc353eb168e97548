"""K9's launch plan (``ops/bcd_sweep_tiled.tiled_tiling``), the order in
which it streams a CTA's chunks (``tiled_schedule``) and its design bound
(``chip_smoke.tiled_design_work``), all pure functions checked on the CPU.
The kernel itself runs only on a card (tests/test_torch_cuda.py); its plain
version is held to the JAX tiled kernel in tests/test_torch_ops.py."""

import itertools
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from convex_optimization_tpu_torch.ops.bcd_sweep import (  # noqa: E402
    H100_SMS,
    MAX_SMEM_BYTES,
    sweep_route,
)
from convex_optimization_tpu_torch.ops.bcd_sweep_tiled import (  # noqa: E402
    K9_CONS,
    K9_CONS_WARPS,
    TiledPlan,
    tiled_schedule,
    tiled_tiling,
)


def _first_design_fits(B: int, m: int, sms: int) -> bool:
    """The first design's plan existed where its smallest ring (three
    slots of one coordinate), r and two B-vectors fit in shared memory."""
    rows = -(-m // min(sms, m))
    return 4 * (3 * rows + rows + 2 * B) <= MAX_SMEM_BYTES


def _plan_invariants(p: TiledPlan, B: int, m: int, sms: int = H100_SMS):
    """What csrc/sweep_tiled.cu's plan_ok requires, and the fit."""
    assert p.B == B and p.smem_bytes <= MAX_SMEM_BYTES
    assert p.grid <= min(sms, m)
    assert p.grid * p.rows >= m > (p.grid - 1) * p.rows
    assert p.ld % 4 == 0        # one bulk copy a run, rows 16-byte aligned
    if p.vec:
        assert m % 4 == 0 and p.rows % 4 == 0 and p.ld >= p.rows
        assert p.ld % 8 == 4    # conflict-free float4 reads of two rows
    else:                       # a run 0-3 floats into its row
        assert p.ld >= p.rows + 3
    assert 1 <= p.chunk <= B and p.slots >= 1
    assert 0 <= p.kept <= min(p.n_chunks, p.slots)
    assert p.kept == p.n_chunks or p.slots > p.kept   # a slot to stream
    assert 1 <= p.s1 <= 32 and p.s1 & (p.s1 - 1) == 0
    q = p.rows // 4 if p.vec else p.rows
    assert p.s2 == 1 or (p.s2 <= p.chunk and p.s2 * q <= K9_CONS)
    assert p.rw in (1, K9_CONS_WARPS)
    # a block's uses (the kernel's int counters: < 2^31 a sweep) <= 2 B
    assert 2 * p.n_chunks <= 2 * B


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("B", [32, 80, 200, 2000, 4000])
def test_tiled_tiling_plans_every_shape_k9_takes(B, sms):
    """Every (B, m) that sweep_route sends to K9, from the first width past
    K1's fit rule to m = 200 000 (ragged and m % 4 != 0 included), gets a
    plan that fits 227 KB, wherever the first design had one."""
    m0 = 1
    while sweep_route(B, m0, sms) == "k1":
        m0 = m0 * 2 if m0 < 4096 else m0 + 4096
    while m0 > 1 and sweep_route(B, m0 - 1, sms) == "k9":
        m0 -= 1
    ms = {m0, m0 + 1, m0 + 2, m0 + 3, 20_000, 20_003, 100_000, 100_003,
          150_001, 200_000}
    for m in sorted(v for v in ms if v >= m0):
        assert sweep_route(B, m, sms) == "k9"
        p = tiled_tiling(B, m, sms)
        assert p is not None, (B, m)
        _plan_invariants(p, B, m, sms)


@pytest.mark.parametrize("B,m", [(4000, 200_000), (30_000, 64),
                                 (14_000, 1000), (20_000, 20_000)])
def test_tiled_tiling_plans_wherever_the_first_design_did(B, m):
    """The last resort takes no more shared memory than the first
    design's smallest ring, so no shape loses its plan."""
    p = tiled_tiling(B, m, H100_SMS)
    assert (p is not None) or not _first_design_fits(B, m, H100_SMS)
    if p is not None:
        _plan_invariants(p, B, m)


def test_tiled_tiling_at_config4():
    """Config 4's K9 route (B = 2000, m = 20 000): 152 rows a CTA, chunks of
    105 coordinates (64 KB), 3 slots, of which 2 keep phase 1's last
    chunks and 1 streams across the barriers."""
    p = tiled_tiling(2000, 20_000, H100_SMS)
    assert p == TiledPlan(B=2000, grid=132, rows=152, ld=156, vec=True,
                          chunk=105, slots=3, kept=2, s1=4, s2=9, rw=11)
    assert p.n_chunks == 20 and p.smem_bytes == 219_488
    _plan_invariants(p, 2000, 20_000)


def test_tiled_tiling_at_the_tall_shape():
    """The tall shape (B = 80, m = 100 000): a CTA's slab of a block is 80
    runs of 760 floats (243 KB), so the ring keeps 2 of its 4 chunks of 21
    coordinates (38 coordinates) and phase 2 re-reads 2."""
    p = tiled_tiling(80, 100_000, H100_SMS)
    assert p == TiledPlan(B=80, grid=132, rows=760, ld=764, vec=True,
                          chunk=21, slots=3, kept=2, s1=32, s2=1, rw=11)
    assert p.n_chunks == 4 and p.smem_bytes == 197_664
    _plan_invariants(p, 80, 100_000)


@pytest.mark.parametrize("B,m,n_chunks,kept,last,vec", [
    (32, 256, 1, 1, 32, True), (40, 200, 1, 1, 40, True),
    (2000, 4096, 5, 2, 180, True), (2000, 20_000, 20, 2, 5, True),
    (80, 100_003, 4, 2, 17, False), (80, 100_000, 4, 2, 17, True)])
def test_tiled_tiling_of_the_card_tests_shapes(B, m, n_chunks, kept, last,
                                               vec):
    """The plans of tests/test_torch_cuda.py's TILED_SHAPES on an H100:
    the whole slab kept (one chunk), or some chunks kept and a ragged last
    chunk, in the float4 and the scalar instance."""
    p = tiled_tiling(B, m, H100_SMS)
    assert (p.n_chunks, p.kept, B - (p.n_chunks - 1) * p.chunk, p.vec) == \
        (n_chunks, kept, last, vec)
    assert kept == n_chunks or last < p.chunk
    _plan_invariants(p, B, m)


@pytest.mark.parametrize("m", [100_003, 20_001, 50_002])
def test_tiled_tiling_takes_the_scalar_instance_at_ragged_m(m):
    p = tiled_tiling(80, m, H100_SMS)
    assert not p.vec
    _plan_invariants(p, 80, m)


@pytest.mark.parametrize("B,m", [(80, 100_000), (2000, 20_000)])
def test_tiled_tiling_takes_the_scalar_instance_for_an_unaligned_a(B, m):
    """An A_t that is not 16-byte aligned cannot take float4 rows: the
    scalar instance, whose runs start 0-3 floats into their rows."""
    p = tiled_tiling(B, m, H100_SMS, aligned=False)
    assert not p.vec and p.rows == -(-m // H100_SMS)
    _plan_invariants(p, B, m)


def test_tiled_tiling_keeps_a_small_slab_whole():
    """Where the ring holds a whole slab, phase 2 copies nothing."""
    p = tiled_tiling(32, 256, H100_SMS)
    assert p.kept == p.n_chunks
    _plan_invariants(p, 32, 256)


def _check_schedule(N: int, S: int, K: int, n_blocks: int) -> list:
    """Replay ``tiled_schedule`` on a ring of S slots: every chunk used once
    per phase, phase 2 backwards; a kept chunk is never copied again; every
    use reads its chunk from the last copy into that slot, issued before
    the use (the kernel waits on it), so no slot was overwritten before its
    last read; no copy goes into a slot whose chunk has not been used
    (copies in flight never exceed the free slots).  Returns the events."""
    ev = tiled_schedule(N, S, K, n_blocks)
    uses = [e for e in ev if e[0] == "use"]
    loads = [e for e in ev if e[0] == "load"]
    for j in range(n_blocks):
        p1 = [e[3] for e in uses if e[1] == j and e[2] == 1]
        p2 = [e[3] for e in uses if e[1] == j and e[2] == 2]
        assert p1 == list(range(N)) and p2 == list(range(N - 1, -1, -1))
        copied = [e[3] for e in loads if e[1] == j]
        for k in range(N):
            # chunks N-K .. N-1 are kept: copied once; the rest twice
            assert copied.count(k) == (1 if k >= N - K else 2), (j, k)
    slot = [None] * S          # [(block, chunk), used since the copy]
    for e in ev:
        if e[0] == "load":
            _, j, _, k, s = e
            assert slot[s] is None or slot[s][1], ("overwritten", e, slot[s])
            slot[s] = [(j, k), False]
        elif e[0] == "use":
            _, j, _, k, s = e
            assert slot[s] is not None and slot[s][0] == (j, k), \
                ("not resident", e, slot[s])
            slot[s][1] = True
    assert all(h is None or h[1] for h in slot)
    return ev


@pytest.mark.parametrize("N,S,K", [
    (n, s, k) for n, s, k in itertools.product(range(1, 8), range(1, 10),
                                               range(0, 8))
    if k <= min(n, s) and (k == n or s > k)])
def test_tiled_schedule_streams_every_chunk_in_order(N, S, K):
    _check_schedule(N, S, K, n_blocks=3)


@pytest.mark.parametrize("N,S,K", [(77, 12, 9), (16, 14, 11), (1, 2, 1),
                                   (1, 1, 0), (3, 3, 3), (34, 12, 9)])
def test_tiled_schedule_keeps_loads_in_flight_across_the_barriers(N, S, K):
    """Across the barriers (issued by phase 1, or right after barrier 1
    where phase 1's last use freed the slot) the ring holds the K kept
    chunks and phase 2's next min(S - K, N - K) chunks, or block j + 1's
    first where phase 2 copies none: the plan's split of the slots."""
    ev = _check_schedule(N, S, K, n_blocks=2)
    at = ev.index(("use", 0, 2, N - 1, (N - 1) % S if K else N % S))
    issued = [e for e in ev[:at] if e[0] == "load"]
    p2 = [e for e in issued if e[1] == 0 and e[2] == 2]
    nxt = [e for e in issued if e[1] == 1]
    assert len(p2) == min(S - K, N - K)
    if K == N:
        assert len(nxt) == min(S - K, N)


def test_design_bound_counts_a_read_and_the_re_read():
    """A once and again less what the ring keeps: 8 m n bytes of A with
    nothing kept, 4 m n with the whole slab kept; x, r, the steps and the
    mask on top; two multiply-adds per element of A."""
    m, n, B = 20_000, 200_000, 2000
    nb = n // B
    extra = 4 * (2 * n + 2 * m + nb) + n
    assert chip_smoke.tiled_design_work(m, n, nb, 26, 0) == (
        8 * m * n + extra, 4 * m * n)
    assert chip_smoke.tiled_design_work(m, n, nb, 26, 77) == (
        4 * m * n + extra, 4 * m * n)
    # config 4's plan keeps the last 2 of 20 chunks of 105: 5 + 105
    # coordinates of each block's 2000 (the last chunk holds 5)
    assert chip_smoke.tiled_design_work(m, n, nb, 105, 2)[0] == \
        8 * m * n - 4 * m * nb * 110 + extra
