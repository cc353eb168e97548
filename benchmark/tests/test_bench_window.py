"""Whole requests: the window ends with the first request to finish at or
after --seconds; the time per job is the whole window over them."""

from benchlib import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(durations, seconds, traces=0, cycle=1):
    clock = Clock()
    seen = []

    def request(k, profiled):
        seen.append((k, profiled))
        clock.t += durations[k % len(durations)]

    return window.run_window(request, seconds, traces, clock, cycle), seen


def test_whole_requests():
    w, seen = run([3.0], 10)
    assert w.requests == 4 and w.seconds == 12.0 and w.per_request() == 3.0
    assert not any(p for _, p in seen) and w.traced == []
    w, _ = run([25.0], 10)
    assert w.requests == 1 and w.per_request() == 25.0
    w, _ = run([4.0, 6.0], 10)
    assert w.requests == 2 and w.ends == [4.0, 10.0]


def test_whole_cycles():
    w, _ = run([3.0, 5.0, 4.0], 10, cycle=3)
    assert w.requests == 3 and w.seconds == 12.0
    w, _ = run([3.0, 5.0, 4.0], 13, cycle=3)
    assert w.requests == 6 and w.per_request() == 4.0


def test_traced_requests_are_from_the_middle():
    w, seen = run([3.0], 10, traces=2)
    assert w.traced == [2, 3] and seen[2:4] == [(2, 1), (3, 2)]
    assert [p for _, p in seen] == [0, 0, 1, 2]        # 6 >= 5 starts them
    w, seen = run([25.0], 10, traces=2)
    assert w.traced == [1, 2] and w.requests == 3      # goes on to profile
    w, _ = run([25.0, 25.0], 10, traces=2, cycle=2)
    assert w.traced == [1, 2] and w.requests == 4      # and ends a cycle
