"""Mrays/s: the rays of every batch completed in the window over the window
(host clock)."""


def read(rec):
    if rec.get("unit") != "batch":
        return None
    batches = len(rec["stamps"]) - 1
    return rec["rays_per_unit"] * batches / (rec["stamps"][-1] - rec["stamps"][0]) / 1e6
