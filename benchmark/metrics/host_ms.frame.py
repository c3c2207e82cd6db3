"""ms: the host's time from a frame's stamp until the loop's present call
returns (its events, the context's update, the render and present calls
enqueued), mean over the traced window."""

from benchmark.reduce import mean_ms


def read(rec):
    return mean_ms(rec, "host_s", "frame")
