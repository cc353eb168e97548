"""Iterations per lambda path (sweeps or FISTA steps over all points), as
the program's ``PathResult.sweeps`` counts them, averaged over the
window."""

from benchlib.readers import mean


def read(rec):
    return mean(rec, "iters")
