"""Structured metrics: per-check records, JSONL, a wall timer.

Counterpart of ``convex_optimization_tpu/utils/metrics.py``: the same
record schema and JSONL lines (a ``meta`` line, then one ``check`` line
per convergence check), so the two packages' files read alike.  The JAX
package's bandwidth meter (GB/s from the host's wall over an assumed
count of passes over A) has no counterpart: the port's spans
(``utils/trace``) time its layers, and the benchmark's rooflines
(``benchmark/roofline/``) score its kernels from a device trace.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict, dataclass
from typing import IO, Iterable, Optional

from convex_optimization_tpu_torch.utils.device import sync

@dataclass
class SweepRecord:
    """One convergence-check record (the JSONL row schema)."""

    iteration: int
    primal: float
    dual: float
    gap: float
    rel_gap: float
    nnz: int
    t_wall_s: float = 0.0


def records_from_history(history: dict, wall_time_s: float = 0.0
                         ) -> list[SweepRecord]:
    """Expand a Result.history dict into per-check records; the wall time
    is apportioned linearly by iteration (the checks carry no host clock
    of their own)."""
    n = len(history["iteration"])
    total_iters = int(history["iteration"][-1]) if n else 0
    out = []
    for i in range(n):
        it = int(history["iteration"][i])
        out.append(SweepRecord(
            iteration=it,
            primal=float(history["primal"][i]),
            dual=float(history["dual"][i]),
            gap=float(history["gap"][i]),
            rel_gap=float(history["rel_gap"][i]),
            nnz=int(history["nnz"][i]),
            t_wall_s=(wall_time_s * it / total_iters) if total_iters else 0.0,
        ))
    return out


def write_jsonl(records: Iterable[SweepRecord], fp: IO[str],
                meta: Optional[dict] = None) -> None:
    if meta:
        fp.write(json.dumps({"record": "meta", **meta}) + "\n")
    for r in records:
        fp.write(json.dumps({"record": "check", **asdict(r)}) + "\n")
    fp.flush()


class WallTimer:
    """Context-manager wall timer that waits for ``device``'s queued work
    (``utils.device.sync``) at entry and exit, so the wall covers what the
    card ran, not what the host queued."""

    def __init__(self, device=None):
        self.device = device

    def __enter__(self):
        if self.device is not None:
            sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            sync(self.device)
        self.elapsed = time.perf_counter() - self.t0

    def __float__(self):
        return self.elapsed


def summary_line(name: str, res, extra: Optional[dict] = None,
                 file: Optional[IO[str]] = None) -> None:
    """One human-readable summary row per solve (to stderr by default)."""
    msg = (f"[{name}] method={res.method} iters={res.iterations} "
           f"rel_gap={res.rel_gap:.2e} nnz={res.nnz} "
           f"wall={res.wall_time_s:.3f}s iters/s={res.iters_per_sec:.1f} "
           f"converged={res.converged}")
    if extra:
        msg += " " + " ".join(f"{k}={v}" for k, v in extra.items())
    print(msg, file=sys.stderr if file is None else file)
