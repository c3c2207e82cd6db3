"""ms: the 95th percentile of every frame interval in the window (host clock)."""

from benchmark.reduce import intervals, p95


def read(rec):
    if rec.get("unit") != "frame":
        return None
    return 1e3 * p95(intervals(rec["stamps"]))
