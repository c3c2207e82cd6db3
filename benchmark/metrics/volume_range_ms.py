"""ms: the renderer's read of a float volume's data range, the program's
span ``volume.range`` (one ``aminmax`` over the volume on its device and
the read of its two numbers, inside ``volume.setup``), summed over the
traced run's whole ``recording()``. Nothing where the program has no such
span."""


def read(rec):
    prog = rec.get("program")
    if prog is None or "volume.range" not in prog["spans"]:
        return None
    return prog["spans"]["volume.range"]["total_s"] * 1e3
