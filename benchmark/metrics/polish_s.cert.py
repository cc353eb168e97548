"""Seconds of the f64 support polish per solve: the benchmark's clock
around ``polish_support``, averaged over the window."""

from benchlib.readers import mean


def read(rec):
    return mean(rec, "polish_s")
