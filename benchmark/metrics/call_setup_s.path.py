"""Seconds of the call's own set-up per path: the ``cot.setup`` spans
(``lambda_max_t``, and ``spectral_norm_sq_t`` or
``prepare_batched_solver``) over the ``cot.lambda_path`` entries, in the
device-only profiled request (``benchlib/spans.py``)."""

from benchlib.spans import per_request


def read(rec):
    return per_request("cot.setup", "cot.lambda_path")
