"""%: K8's bound (benchmark.roofline.k8) over its device time, summed over
the profiled batches."""

from benchmark.reduce import roofline


def read(rec):
    return roofline(rec, "K8", "batch")
