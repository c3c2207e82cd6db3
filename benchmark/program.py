"""The program's own spans (``vokselis_torch.engine.profiler.span``) in a
profiler window: the device's idle time put down to what the program was
doing on the host.

Under a ``torch.profiler`` session each of the program's spans is a range on
the host's timeline only, never mirrored on the device's, so
``reduce.profile_window`` reads the same with them as without them.
"""

from __future__ import annotations

from benchmark.reduce import HOST_SPANS, WINDOW_SPAN, _union

OUTSIDE = "outside"


def idle_by_span(events, names) -> dict | None:
    """Seconds by span key: the idle gaps of the profiled window (the span
    :data:`reduce.WINDOW_SPAN`; device operations as ``profile_window``
    counts them), each instant put down to the innermost of the program's
    spans open then (host ranges on the window's thread named in ``names``),
    else to :data:`OUTSIDE`. None if the session holds no window or no
    device operation inside it."""
    from torch.autograd import DeviceType

    windows = [e for e in events if e.device_type == DeviceType.CPU and e.name == WINDOW_SPAN]
    if len(windows) != 1:
        return None
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    busy, spans = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in HOST_SPANS or e.name == WINDOW_SPAN:
                continue  # the device's mirror of a span the benchmark opened
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                busy.append((lo, hi))
        elif e.name in names and e.thread == windows[0].thread:
            spans.append((lo, hi, e.name))
    if not busy:
        return None
    busy = _union(busy)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]
    out = {}
    for lo, hi in gaps:
        inside = [s for s in spans if s[0] < hi and s[1] > lo]
        cuts = sorted({lo, hi} | {t for s in inside for t in s[:2] if lo < t < hi})
        for a, b in zip(cuts, cuts[1:]):
            # spans on one thread nest: the innermost open one started last
            open_ = [s for s in inside if s[0] <= a and s[1] >= b]
            name = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out
