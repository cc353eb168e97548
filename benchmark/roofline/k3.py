"""K3, ``neg_at_r_t``: z = -A^T r - lam2 x over A_t (``csrc/matvec.cu``),
with a finishing kernel where the columns of r are split.

Work of one call: A once, r and x in, z out; one multiply-add per element
of A.  A frozen copy of the arithmetic in ``chip_smoke.compare_matvecs``.
"""

KERNELS = ("neg_at_r_kernel", "atr_finish_kernel")


def work(config: dict, traffic: dict) -> tuple[int, int]:
    m, n = config["m"], config["n"]
    return 4 * m * n + 4 * m + 8 * n, 2 * m * n
