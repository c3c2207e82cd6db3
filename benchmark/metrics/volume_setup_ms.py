"""ms: the renderer's set-up of its volume, the program's span
``volume.setup`` (the volume onto its device and its occupancy table built
there), summed over the traced run's whole ``recording()``. Nothing where
the program has no such span."""


def read(rec):
    prog = rec.get("program")
    if prog is None or "volume.setup" not in prog["spans"]:
        return None
    return prog["spans"]["volume.setup"]["total_s"] * 1e3
