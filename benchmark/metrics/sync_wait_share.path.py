"""Per cent of the solver loop the host sat blocked in the checks' one
sync: ``cot.sync`` over ``cot.loop``, in the device-only profiled request
(``benchlib/spans.py``).  High: the card sets the loop's pace; low: the
host issuing steps does."""

from benchlib.spans import sync_wait_share


def read(rec):
    return sync_wait_share()
