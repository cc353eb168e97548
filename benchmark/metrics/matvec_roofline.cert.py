"""K2 and K3 together: their share of their rooflines in the profiled
request (both bounds over both times)."""

from benchlib.readers import roofline_share


def read(rec):
    return roofline_share(rec, ["k2", "k3"])
