"""ms per iteration of the solve: the benchmark's clock around ``solve``
(synchronised), over the iterations, summed over every request."""

from benchlib.readers import ms_per_iter


def read(rec):
    return ms_per_iter(rec, "solve_s")
