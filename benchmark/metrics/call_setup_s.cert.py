"""Seconds of the call's own set-up per solve: the ``cot.setup`` spans
(``spectral_norm_sq_t``, or K4 and the sweep's plan) over the ``cot.solve``
entries, in the device-only profiled request (``benchlib/spans.py``)."""

from benchlib.spans import per_request


def read(rec):
    return per_request("cot.setup", "cot.solve")
