"""K5, ``batch_sweep_t``: one BCD sweep of all L path points at once
(``csrc/sweep_batch.cu``).

Work of one call: A once, X and R in and out for L points, the steps and
the L lambdas; two multiply-adds per element of A per point.  A frozen
copy of the arithmetic in ``chip_smoke.compare_batch_kernels``.
"""

from benchlib.readers import block_width

KERNELS = ("batch_sweep_kernel",)


def work(config: dict, traffic: dict) -> tuple[int, int]:
    m, n, L = config["m"], config["n"], config["path_len"]
    nb = n // block_width(n, traffic["solver"]["block_size"])
    return (4 * m * n + 4 * L * (2 * n + 2 * m) + 4 * (L + nb),
            4 * m * n * L)
