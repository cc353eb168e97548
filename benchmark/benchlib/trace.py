"""Reduce ``torch.profiler`` traces of requests to what the per-layer
metrics read.

A traced run profiles two requests.  The first is traced on the device
alone (CUDA activity: kernels, copies, runtime calls), which costs the host
little, so its busy seconds over its length, timed by the benchmark's
clock, give the device's idle share, and its kernels' calls and seconds
the rooflines.  The second is traced on the host too (every operator, and
the benchmark's ``bench.`` spans); recording each operator slows a loop
that issues many small ones, so from it come only the names of the idle
gaps.  Each request ends synchronised, so every device operation it caused
lies inside it.  From a Chrome trace:

  * device operations (kernels, copies, memsets) by name: calls and
    seconds;
  * busy seconds: the union of the device operations' intervals;
  * idle gaps (host traces): the stretches of the ``bench.request`` span
    with no device operation, each named by what the host was doing at
    its middle (the innermost host event there, under the innermost
    ``bench.`` span).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
REQUEST_SPAN = "bench.request"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: dict            # device op name -> [calls, seconds]
    idle: dict           # host activity -> seconds of idle device
    launches: dict       # the program's own launch counts in the request

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(calls, seconds) of the kernels whose function name is
        ``pattern`` (a whole identifier, template arguments allowed)."""
        rx = re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(pattern)
                        + r"($|[^A-Za-z0-9_])")
        calls, secs = 0, 0.0
        for name, (c, s) in self.ops.items():
            if rx.search(short(name)):
                calls += c
                secs += s
        return calls, secs

    def ops_calls(self) -> dict:
        """Calls of the program's own kernels (PyTorch's are left out)."""
        return {short(n): c for n, (c, s) in self.ops.items()
                if "::" not in short(n) and not n.startswith("Mem")}

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, s) for n, (c, s) in self.ops.items()),
                     key=lambda t: -t[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda t: -t[1])[:top]
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list: ``void (anonymous namespace)::k<true>(float*)`` is
    ``k<true>``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    return s[:120]


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _labels(host: list, times: list) -> list:
    """What the host was doing at each of the sorted ``times``: the
    innermost event covering it, under the innermost ``bench.`` span.
    Host events of one thread nest, so one sweep with a stack finds
    them."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    stack: list = []
    out = []
    i = 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        live = [e for e in stack if e[1] >= t]
        span = next((e[2] for e in reversed(live)
                     if e[2].startswith("bench.") and e[2] != REQUEST_SPAN),
                    None)
        inner = next((e[2] for e in reversed(live)
                      if not e[2].startswith("bench.")), None)
        parts = [p for p in (span, inner) if p is not None]
        out.append("/".join(parts) if parts else "host")
    return out


def summarize(events: list, launches: dict | None = None,
              window_s: float | None = None) -> TraceSummary:
    """Summarise Chrome-trace events (times in microseconds).  With
    ``window_s`` (a device trace: no host spans) the request lasted that
    long and every device operation belongs to it; without, the
    ``bench.request`` span bounds the request."""
    if window_s is not None:
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS and "dur" in e]
        t0 = min((e["ts"] for e in dev), default=0.0)
        t1 = max((e["ts"] + e["dur"] for e in dev), default=0.0)
        req = {}
    else:
        spans = [e for e in events if e.get("name") == REQUEST_SPAN
                 and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        if not spans:
            raise ValueError(f"the trace holds no {REQUEST_SPAN} span")
        req = max(spans, key=lambda e: e["dur"])
        t0, t1 = req["ts"], req["ts"] + req["dur"]
    ops: dict = collections.defaultdict(lambda: [0, 0.0])
    busy_iv = []
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, te = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") in DEVICE_CATS:
            a, b = max(ts, t0), min(te, t1)
            if b <= a:
                continue
            ops[e["name"]][0] += 1
            ops[e["name"]][1] += e["dur"] * 1e-6
            busy_iv.append((a, b))
        elif (req and e.get("cat") in HOST_CATS
              and e.get("tid") == req.get("tid")
              and e.get("pid") == req.get("pid") and te > t0 and ts < t1):
            host.append((ts, te, e["name"]))
    busy = _union(busy_iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    if window_s is not None:
        return TraceSummary(window_s=window_s, busy_s=busy_s,
                            ops={k: (v[0], v[1]) for k, v in ops.items()},
                            idle={}, launches=dict(launches or {}))
    gaps = []
    prev = t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle: dict = collections.defaultdict(float)
    for (a, b), label in zip(gaps, _labels(host, [0.5 * (a + b)
                                                   for a, b in gaps])):
        idle[label] += (b - a) * 1e-6
    return TraceSummary(
        window_s=(t1 - t0) * 1e-6, busy_s=busy_s,
        ops={k: (v[0], v[1]) for k, v in ops.items()},
        idle=dict(idle), launches=dict(launches or {}))


def profile(fn, launches_before: dict, launches_now, host: bool,
            clock) -> TraceSummary:
    """Run ``fn`` (one request, synchronised) under ``torch.profiler``,
    on the device alone or (``host``) on the host too, and summarise its
    trace.  The Chrome trace goes to a temporary file, read back and
    deleted."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = ([ProfilerActivity.CPU] if host or not torch.cuda.is_available()
            else []) + [ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = clock()
        if host:
            with record_function(REQUEST_SPAN):
                fn()
        else:
            fn()
        window_s = clock() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    now = launches_now()
    launched = {k: now.get(k, 0) - launches_before.get(k, 0) for k in now}
    return summarize(events, {k: v for k, v in launched.items() if v},
                     None if host else window_s)
