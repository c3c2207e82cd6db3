"""%: K7's bound (benchmark.roofline.k7) over its device time, summed over
the profiled frames."""

from benchmark.reduce import roofline


def read(rec):
    return roofline(rec, "K7", "frame")
