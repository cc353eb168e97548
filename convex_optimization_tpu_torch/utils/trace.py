"""Spans: the port's own clock on the routes it times, and, while a
``torch.profiler`` session records, a bounded record of them in memory.

    from convex_optimization_tpu_torch.utils.trace import span

    with span("cot.setup") as setup:
        ...
    setup.seconds          # always: two perf_counter_ns reads

A span always takes its own start and end, so the caller reads its
``seconds`` (``Result`` and ``PolishResult`` take their walls and set-up
times from spans).  It is recorded only while recording is on, which is
while a profiler session records on this thread
(``torch._C._autograd._profiler_enabled()``, one flag read).  A recorded
span keeps its name, start and end (``perf_counter_ns``), the recorded
span open around it on the same thread (its parent), the session it
belongs to and its small attributes (iterations, sweeps, columns, bytes);
a ``CpuSpan`` also keeps this thread's CPU seconds and minor page faults
over it.  While recording, a span also enters
``torch.profiler.record_function(name)``, so the port's spans lie in the
profiler's Chrome trace on its clock, around the operators they issued;
with recording off it enters nothing and records nothing.

Sessions count the profiler's starts: torch calls
``torch.autograd.profiler._run_on_profiler_start`` each time a profiler
starts recording, and this module wraps it once, when imported, to count
them.  The first profiler session after import is session 0, the next
session 1, and so on, even when two sessions follow each other with no
span between them (a torch without the hook records every span in
session 0).

The record holds at most ``Recorder.cap`` spans; past that it counts the
spans it dropped.  Nothing is written out: a caller reads ``records()``.

The JAX package has no recorder: its clocks are ``perf_counter`` pairs
(``convex_optimization_tpu/api.py``), the polish's ``tick`` printer
(``convex_optimization_tpu/solvers/polish.py``) and the CLI's
``jax.profiler`` trace (``convex_optimization_tpu/cli.py --profile``).
Here spans take the place of all three.

Span names start with ``cot.``.  The sites (``PERF.md`` §3 has the table
of which metric reads each):

  cot.solve, cot.lambda_path, cot.polish     the entries
  cot.setup                                  a call's own set-up
  cot.loop > cot.steps, cot.check > cot.sync  the solver loops
  cot.point, cot.confirm                     a FISTA path's point, the
                                             batched path's f64 check
  cot.polish.{setup,round,gather,cd64,witness,near}   the polish's stages
"""

from __future__ import annotations

import resource
import threading
import time

import torch
from torch.autograd.profiler import record_function

_enabled = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns
_RUSAGE = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)


def _usage() -> tuple[float, int]:
    """(CPU seconds of this thread, its minor page faults so far)."""
    return time.thread_time(), resource.getrusage(_RUSAGE).ru_minflt


class Span:
    """One timed region, a context manager; see the module docstring.
    ``span(name, **attrs)`` makes one."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent",
                 "session", "cpu_s", "minflt", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._rf = None

    def __enter__(self) -> "Span":
        if _enabled():
            RECORDER._open(self)
        self.start_ns = _now()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.end_ns = _now()
        if self._rf is not None:
            RECORDER._close(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes known only once the work is done (a recorded
        span keeps them too)."""
        self.attrs.update(attrs)


span = Span


class CpuSpan(Span):
    """A span that also takes this thread's CPU seconds and minor page
    faults over its region (``cpu_s``, ``minflt``)."""

    __slots__ = ("_usage0",)

    def __enter__(self) -> "CpuSpan":
        self._usage0 = _usage()
        return super().__enter__()

    def __exit__(self, et, ev, tb) -> None:
        super().__exit__(et, ev, tb)
        cpu, flt = _usage()
        self.cpu_s = cpu - self._usage0[0]
        self.minflt = flt - self._usage0[1]


class Recorder:
    """The process's record of spans (one, ``RECORDER``)."""

    def __init__(self, cap: int = 200_000):
        self.cap = cap
        self.spans: list = []
        self.dropped = 0
        self.starts = 0              # profiler sessions started
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, s: Span) -> None:
        stack = self._stack()
        s.parent = stack[-1] if stack else None
        s.session = max(self.starts - 1, 0)
        s.cpu_s, s.minflt = 0.0, 0
        stack.append(s)
        if len(self.spans) < self.cap:
            self.spans.append(s)
        else:
            self.dropped += 1
        s._rf = record_function(s.name)
        s._rf.__enter__()

    def _close(self, s: Span) -> None:
        rf, s._rf = s._rf, None
        rf.__exit__(None, None, None)
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()

    @property
    def session(self) -> int:
        """The newest session's id (-1 before the first)."""
        return self.starts - 1

    def records(self, session: int | None = None) -> list[dict]:
        """The recorded spans (of ``session`` only, when given) in the
        order they opened, as dicts; ``parent`` is the parent's index in
        the list, or None."""
        chosen = [s for s in self.spans
                  if session is None or s.session == session]
        index = {id(s): i for i, s in enumerate(chosen)}
        return [{"name": s.name, "start_ns": s.start_ns,
                 "end_ns": s.end_ns, "seconds": s.seconds,
                 "parent": (None if s.parent is None
                            else index.get(id(s.parent))),
                 "session": s.session, "attrs": dict(s.attrs),
                 "cpu_s": s.cpu_s, "minflt": s.minflt} for s in chosen]

    def clear(self) -> None:
        """Forget the recorded spans and the dropped count (sessions go on
        counting)."""
        self.spans = []
        self.dropped = 0


RECORDER = Recorder()


def _hook_profiler_starts() -> None:
    """Count every profiler start through torch's own start hook."""
    prof = torch.autograd.profiler
    start = getattr(prof, "_run_on_profiler_start", None)
    if start is None or getattr(start, "counts_sessions", False):
        return

    def _run_on_profiler_start():
        start()
        RECORDER.starts += 1

    _run_on_profiler_start.counts_sessions = True
    prof._run_on_profiler_start = _run_on_profiler_start


_hook_profiler_starts()
