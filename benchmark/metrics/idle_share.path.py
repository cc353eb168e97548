"""Per cent of the profiled request in which no operation ran on the
device."""

from benchlib.readers import idle_share


def read(rec):
    return idle_share(rec)
