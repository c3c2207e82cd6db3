"""ms: CUDA events around the demo's render call (the camera copied into the
exact frame's graph, ray planes and K1, the frame copied out), mean over
the traced window."""

from benchmark.reduce import mean_ms


def read(rec):
    return mean_ms(rec, "render_s", "frame")
