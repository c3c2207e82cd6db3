"""Reduction of host stamps and one profiler window to numbers.

The yardstick's arithmetic: a window's rate and tail from the host stamps
of its unit boundaries, and from a ``torch.profiler`` session the device's
busy time, the time of each kernel and the device's idle gaps, each gap
split by what the host was doing then (the benchmark's own
``record_function`` spans around the calls into each layer).
"""

from __future__ import annotations

import re
import statistics

WINDOW_SPAN = "bench.window"
# the spans the drivers open around the calls into each layer; a gap's time
# outside all of them is the loop's own
HOST_SPANS = ("client.wait", "ctx.update", "demo.render", "ctx.render", "batch.step")
OTHER_HOST = "loop"


def intervals(stamps) -> list:
    return [b - a for a, b in zip(stamps, stamps[1:])]


def p95(values) -> float:
    """The 95th percentile (Python's exclusive quantiles)."""
    return statistics.quantiles(values, n=100)[94]


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.strip()
    if name.endswith(")"):  # cut the trailing argument list, parentheses matched
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.replace("(anonymous namespace)::", "").replace("void ", "").strip()[:120]


def _union(spans) -> list:
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def profile_window(events) -> dict | None:
    """From a profiler session's ``events()``: the window the driver marked
    with the span :data:`WINDOW_SPAN`, and in it the device's busy seconds,
    each device operation's seconds and count by short name, and the idle
    gaps' seconds by the host span they fall in. None if the session holds
    no window or no device event inside it."""
    from torch.autograd import DeviceType

    windows = [e.time_range for e in events
               if e.device_type == DeviceType.CPU and e.name == WINDOW_SPAN]
    if len(windows) != 1:
        return None
    w0, w1 = windows[0].start, windows[0].end
    ops, counts, spans = {}, {}, []
    host = {name: [] for name in HOST_SPANS}
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.name in host or e.name == WINDOW_SPAN:
            # a span the driver opened; the profiler mirrors it on the device's
            # timeline too, where it is no device operation
            if e.device_type == DeviceType.CPU and e.name in host:
                host[e.name].append((lo, hi))
        elif e.device_type == DeviceType.CUDA:
            lo, hi = max(lo, w0), min(hi, w1)
            if hi <= lo:
                continue
            name = short_name(e.name)
            ops[name] = ops.get(name, 0.0) + (hi - lo) * 1e-6
            counts[name] = counts.get(name, 0) + 1
            spans.append((lo, hi))
    if not spans:
        return None
    busy = _union(spans)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]
    by_host = {}
    for lo, hi in gaps:
        left = hi - lo
        for name, marks in host.items():
            cover = sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in marks)
            if cover > 0.0:
                by_host[name] = by_host.get(name, 0.0) + cover * 1e-6
                left -= cover
        if left > 0.0:
            by_host[OTHER_HOST] = by_host.get(OTHER_HOST, 0.0) + left * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
            "ops": ops, "counts": counts, "gaps": by_host}


def kernel(profile: dict, name: str) -> tuple:
    """``(seconds, launches)`` of the ``__global__`` function ``name`` in a
    :func:`profile_window` summary."""
    pattern = re.compile(r"(?<!\w)" + re.escape(name) + r"(?!\w)")
    hits = [k for k in profile["ops"] if pattern.search(k)]
    return sum(profile["ops"][k] for k in hits), sum(profile["counts"][k] for k in hits)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def roofline(rec: dict, name: str, unit: str):
    """Percent: the kernel ``name``'s bound over its measured time in a
    traced run of ``unit`` cells, summed over the profiled units; None where
    the run has no profile, or the profile lacks any of the units' launches."""
    if rec.get("unit") != unit or name not in rec.get("kernels", {}):
        return None
    seconds, launches = rec["kernels"][name]
    if launches != rec["profile_units"] or seconds <= 0.0:
        return None
    return 100.0 * rec["bounds"][name] / seconds


def idle_share(rec: dict, unit: str):
    """Percent of the profiled window in which no device operation ran."""
    prof = rec.get("profile")
    if rec.get("unit") != unit or prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mean_ms(rec: dict, key: str, unit: str):
    """The mean of the traced window's per-unit span ``key`` (seconds), ms."""
    values = rec.get("spans", {}).get(key)
    if rec.get("unit") != unit or not values:
        return None
    return 1e3 * sum(values) / len(values)
