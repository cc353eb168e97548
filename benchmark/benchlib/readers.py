"""Arithmetic shared by the per-layer metrics' readers.

Each reader returns None where its run holds nothing to read (no spans, no
trace, no call of its kernels, a card without listed peaks), and the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

from benchlib import peaks, spec


def total(rec, key: str) -> float | None:
    vals = [s[key] for s in rec.spans if key in s]
    return sum(vals) if vals else None


def mean(rec, key: str) -> float | None:
    vals = [s[key] for s in rec.spans if key in s]
    return sum(vals) / len(vals) if vals else None


def ms_per_iter(rec, time_key: str) -> float | None:
    """Host seconds around the entry over the iterations it ran, summed
    over every request, in ms."""
    t, k = total(rec, time_key), total(rec, "iters")
    if t is None or not k:
        return None
    return 1e3 * t / k


def idle_share(rec) -> float | None:
    """Per cent of the profiled request with no device operation."""
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def block_width(n: int, target: int) -> int:
    """The BCD block width for n columns: the largest multiple of 8 at
    most ``target`` that divides n (the width the solvers pick where one
    exists; only the bound's 4 bytes per block depend on it)."""
    fits = [b for b in range(8, max(target, 8) + 1, 8) if n % b == 0]
    return fits[-1] if fits else max(8, target - target % 8)


def roofline_share(rec, kernels: list) -> float | None:
    """Per cent of the roofline that the traced calls of ``kernels``
    (names of ``roofline/<kernel>.py``) reach together: each call's bound
    (its bytes at peak bandwidth or its operations at peak rate) times the
    calls the trace holds, over those calls' device seconds.  Dividing per
    call keeps the share honest where the profiler drops calls."""
    tr = rec.trace
    if tr is None:
        return None
    bound, secs = 0.0, 0.0
    for k in kernels:
        mod = spec.roofline(k)
        calls, _ = tr.kernel(mod.KERNELS[0])
        if not calls:
            continue
        b = peaks.bound_s(mod.work(rec.cell.config, rec.cell.traffic),
                          rec.device_name)
        if b is None:
            return None
        bound += calls * b
        secs += sum(tr.kernel(name)[1] for name in mod.KERNELS)
    if secs <= 0:
        return None
    return 100.0 * bound / secs
