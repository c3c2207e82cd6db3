"""ms: CUDA events around the context's present call (the Presenter's graph:
ACES and sRGB into the display image), mean over the traced window."""

from benchmark.reduce import mean_ms


def read(rec):
    return mean_ms(rec, "present_s", "frame")
