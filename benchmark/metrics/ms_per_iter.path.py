"""ms per iteration of the path: the benchmark's clock around
``lambda_path`` (synchronised), over its sweeps or steps, summed over
every request."""

from benchlib.readers import ms_per_iter


def read(rec):
    return ms_per_iter(rec, "path_s")
