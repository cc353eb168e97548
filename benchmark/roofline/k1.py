"""K1, ``sweep_t``: one BCD sweep over A_t (``csrc/sweep.cu``).

Work of one call, each input read once and each output written once: A
once, x, r, the block steps and the keep mask in, x and r out; two
multiply-adds per element of A.  A frozen copy of ``chip_smoke.sweep_work``.
"""

from benchlib.readers import block_width

KERNELS = ("sweep_kernel",)


def work(config: dict, traffic: dict) -> tuple[int, int]:
    m, n = config["m"], config["n"]
    nb = n // block_width(n, traffic["solver"]["block_size"])
    return 4 * m * n + 4 * (2 * n + 2 * m + nb) + n, 4 * m * n
