"""ms: the device time a profiled frame spends in operations other than K7
(the field's ray planes, the compiled frame's copies, present)."""


def read(rec):
    if rec.get("unit") != "frame" or "K7" not in rec.get("kernels", {}):
        return None
    total = sum(rec["profile"]["ops"].values())
    return 1e3 * (total - rec["kernels"]["K7"][0]) / rec["profile_units"]
