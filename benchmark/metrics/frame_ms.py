"""ms: the window over the frames completed in it (host clock)."""

from benchmark.reduce import intervals


def read(rec):
    if rec.get("unit") != "frame":
        return None
    return 1e3 * (rec["stamps"][-1] - rec["stamps"][0]) / len(intervals(rec["stamps"]))
