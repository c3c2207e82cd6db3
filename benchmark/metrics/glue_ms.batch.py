"""ms: the device time a batch spends in operations other than K1 and K8 (ray
planes, the occupancy table, copies), from the profiled batches."""


def read(rec):
    if rec.get("unit") != "batch" or "kernels" not in rec:
        return None
    total = sum(rec["profile"]["ops"].values())
    k1_s, k8_s = rec["kernels"]["K1"][0], rec["kernels"]["K8"][0]
    return 1e3 * (total - k1_s - k8_s) / rec["profile_units"]
