"""ms per iteration inside the program's solver loop: the ``cot.loop``
spans over the iterations they ran, in the device-only profiled request
(``benchlib/spans.py``).  Unlike ``ms_per_iter.cert``, no call set-up."""

from benchlib.spans import loop_ms_per_iter


def read(rec):
    return loop_ms_per_iter()
