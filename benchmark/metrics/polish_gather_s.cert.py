"""Seconds of the polish's gathers of the support's columns from the card
per solve: the ``cot.polish.gather`` spans over the ``cot.solve`` entries,
in the device-only profiled request (``benchlib/spans.py``)."""

from benchlib.spans import per_request


def read(rec):
    return per_request("cot.polish.gather", "cot.solve")
