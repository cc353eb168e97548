"""K1's share of its roofline in the profiled request."""

from benchlib.readers import roofline_share


def read(rec):
    return roofline_share(rec, ["k1"])
