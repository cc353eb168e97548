"""Seconds of the polish's f64 coordinate descent per solve: the
``cot.polish.cd64`` spans (every expansion round) over the ``cot.solve``
entries, in the device-only profiled request (``benchlib/spans.py``)."""

from benchlib.spans import per_request


def read(rec):
    return per_request("cot.polish.cd64", "cot.solve")
