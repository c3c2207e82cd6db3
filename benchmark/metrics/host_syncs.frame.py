"""syncs a frame: the program's counter ``host_syncs`` (the host waiting
for the device inside the frame loop: ``PassTimer``'s report) over the
frames that the span ``loop.frame`` recorded in the traced run. Nothing
where the program has neither the counter nor the report's span."""


def read(rec):
    prog = rec.get("program")
    if rec.get("unit") != "frame" or prog is None:
        return None
    counters, spans = prog["counters"], prog["spans"]
    if "host_syncs" not in counters and "pass_timer.report" not in spans:
        return None
    frames = spans.get("loop.frame", {}).get("n", 0)
    return counters.get("host_syncs", 0) / frames if frames else None
