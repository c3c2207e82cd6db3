"""%: K1's bound (benchmark.roofline.k1) over its device time, summed over
the profiled batches."""

from benchmark.reduce import roofline


def read(rec):
    return roofline(rec, "K1", "batch")
