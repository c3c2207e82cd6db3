"""s: from the start of the process to the start of the first timed frame or
batch: imports, the card, the inputs, the kernels' builds, graph captures and
warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
