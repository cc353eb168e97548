"""K1's share of its roofline charged for the kept columns alone
(``roofline/k1_kept.py``): each traced K1 call's bound at the mean kept
columns a sweep (the ``cot.loop`` spans' ``kept_col_sweeps`` over their
``iterations``, in the same device-only profiled request), times the
calls, over their device seconds."""

from benchlib import peaks, spans, spec


def read(rec):
    tr, recs = rec.trace, spans.records()
    if tr is None or recs is None:
        return None
    got = spec.metric_reader("kept_share.en").kept_columns(recs)
    mod = spec.roofline("k1_kept")
    calls, secs = tr.kernel(mod.KERNELS[0])
    if got is None or not calls or secs <= 0:
        return None
    kept = got[0] / got[1]
    bound = peaks.bound_s(mod.work(rec.cell.config, rec.cell.traffic, kept),
                          rec.device_name)
    if bound is None:
        return None
    return 100.0 * calls * bound / secs
