"""Read the program's own spans for the per-layer metrics.

The program records its spans in memory while a profiler session records
(``convex_optimization_tpu_torch.utils.trace``, loaded by the run from
this checkout).  A traced run profiles two requests (``benchlib/trace.py``),
each one profiler session: the first on the device alone, the second on
the host too, which slows a loop of small operators.  These readers read
the first: session 0 of the run's process (in a process that ran cells
before, as the tests do, the newest run's first).  Each metric is
normalised per request by the session's entry spans that no other span of
the program encloses (``cot.solve``, ``cot.lambda_path``).

A program without the recorder has nothing to read: every reader returns
None, and the harness leaves the metric out.
"""

from __future__ import annotations

import sys

MODULE = "convex_optimization_tpu_torch.utils.trace"


def records() -> list | None:
    """The spans of the run's device-only profiled request, or None."""
    recorder = getattr(sys.modules.get(MODULE), "RECORDER", None)
    if recorder is None:
        return None
    # the run's two profiled requests are the newest two sessions
    recs = recorder.records(recorder.session - 1)
    return recs or None


def seconds(recs: list, name: str) -> float:
    """Seconds of the spans ``name`` (none of the names the metrics read
    nests in itself on the cells' routes)."""
    return sum(r["seconds"] for r in recs if r["name"] == name)


def requests(recs: list, entry: str) -> int:
    """Requests in the session: entry spans with no enclosing span."""
    return sum(1 for r in recs if r["name"] == entry and r["parent"] is None)


def loop_ms_per_iter() -> float | None:
    """ms of the solver loops (``cot.loop``) over the iterations they
    ran."""
    recs = records()
    if recs is None:
        return None
    iters = sum(r["attrs"].get("iterations", 0) for r in recs
                if r["name"] == "cot.loop")
    if not iters:
        return None
    return 1e3 * seconds(recs, "cot.loop") / iters


def sync_wait_share() -> float | None:
    """Per cent of the loops' time the host sat in the checks' one
    blocking read (``cot.sync``, opened inside ``cot.loop`` only)."""
    recs = records()
    if recs is None:
        return None
    loop = seconds(recs, "cot.loop")
    if loop <= 0:
        return None
    return 100.0 * seconds(recs, "cot.sync") / loop


def per_request(name: str, entry: str) -> float | None:
    """Seconds of the spans ``name`` per request (``entry`` span)."""
    recs = records()
    if recs is None:
        return None
    n = requests(recs, entry)
    if not n or not any(r["name"] == name for r in recs):
        return None
    return seconds(recs, name) / n
