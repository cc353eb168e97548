"""The measured window: whole requests, back to back, one caller.

Requests run in a closed loop from the window's start, in cycles through a
cell's instances.  The window ends when the first cycle to finish at or
after ``seconds`` finishes, so every request in it is whole and every run
does the same mix of work; an end-to-end time per job is the whole elapsed
window over the requests completed in it.  In a traced run one request is
profiled: the first to start at or after half the window (where the first
cycle alone outlasts the window, the window goes on to the next request
and profiles that, then closes at the end of its cycle).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class Window:
    start: float
    end: float
    requests: int
    traced: list             # indices of the profiled requests
    ends: list               # each request's end, seconds from start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def per_request(self) -> float:
        """Seconds per request: the whole window over its requests."""
        return self.seconds / self.requests


def run_window(request: Callable[[int, int], None], seconds: float,
               traces: int = 0,
               clock: Callable[[], float] = time.perf_counter,
               cycle: int = 1) -> Window:
    """Call ``request(k, p)`` for k = 0, 1, ... until the window closes,
    at the end of a cycle of ``cycle`` requests; p is 0 for a request run
    plainly, else which profiled request it is (1, 2, ...).  ``request``
    returns when its work is done (synchronised)."""
    start = clock()
    ends: list = []
    traced: list = []
    k = 0
    while True:
        began = clock() - start
        p = 0
        if len(traced) < traces and (traced or began >= 0.5 * seconds):
            traced.append(k)
            p = len(traced)
        request(k, p)
        ends.append(clock() - start)
        k += 1
        if (k % cycle == 0 and ends[-1] >= seconds
                and len(traced) == traces):
            break
    return Window(start=start, end=start + ends[-1], requests=k,
                  traced=traced, ends=ends)
