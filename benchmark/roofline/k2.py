"""K2, ``ax_minus_b_t``: r = A x - b over A_t (``csrc/matvec.cu``), a
partial-sum kernel and a finishing one per call.

Work of one call: A once, x and b in, r out; one multiply-add per element
of A.  A frozen copy of the arithmetic in ``chip_smoke.compare_matvecs``.
"""

KERNELS = ("ax_partial_kernel", "ax_finish_kernel")


def work(config: dict, traffic: dict) -> tuple[int, int]:
    m, n = config["m"], config["n"]
    return 4 * m * n + 4 * n + 8 * m, 2 * m * n
