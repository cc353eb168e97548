"""K1, ``sweep_t``, charged for the columns its keep mask keeps: one BCD
sweep's useful work where a screen has frozen columns.

A frozen column's coordinate cannot move, so the sweep needs only the kept
columns of A: 4 m bytes and two multiply-adds per element of each.  x, r,
the block steps and the keep mask in, x and r out, as in ``k1.py``.
``kept`` is the mean count of kept columns a sweep (the program's
``kept_col_sweeps`` over its sweeps).  With every column kept it is
``k1.py``'s work.  Frozen with the benchmark.
"""

from benchlib.readers import block_width

KERNELS = ("sweep_kernel",)


def work(config: dict, traffic: dict, kept: float) -> tuple[float, float]:
    m, n = config["m"], config["n"]
    nb = n // block_width(n, traffic["solver"]["block_size"])
    return 4 * m * kept + 4 * (2 * n + 2 * m + nb) + n, 4 * m * kept
