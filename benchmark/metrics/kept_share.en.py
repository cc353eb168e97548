"""Per cent of K1's column reads that the screen's mask keeps useful:
100 x the sum of ``kept_col_sweeps`` over (n x the sum of ``iterations``),
over the ``cot.loop`` spans of the device-only profiled request
(``benchlib/spans.py``).  A program whose loop span carries no
``kept_col_sweeps`` has nothing to read."""

from benchlib import spans


def kept_columns(recs: list) -> tuple[int, int] | None:
    """(sum of kept_col_sweeps, sum of iterations) over the loops that
    count kept columns, or None where none does."""
    loops = [r["attrs"] for r in recs if r["name"] == "cot.loop"
             and "kept_col_sweeps" in r["attrs"]]
    iters = sum(a.get("iterations", 0) for a in loops)
    if not iters:
        return None
    return sum(a["kept_col_sweeps"] for a in loops), iters


def read(rec):
    recs = spans.records()
    got = None if recs is None else kept_columns(recs)
    if got is None:
        return None
    return 100.0 * got[0] / (rec.cell.config["n"] * got[1])
