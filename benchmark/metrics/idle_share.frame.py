"""%: the share of the profiled frames' window in which no device operation
ran."""

from benchmark.reduce import idle_share


def read(rec):
    return idle_share(rec, "frame")
