"""Iterations per certified solve (sweeps or FISTA steps), as the
program's ``Result.iterations`` counts them, averaged over the window."""

from benchlib.readers import mean


def read(rec):
    return mean(rec, "iters")
