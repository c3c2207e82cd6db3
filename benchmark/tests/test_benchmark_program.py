"""The device's idle gaps put down to the program's innermost span
(benchmark.program), on a synthetic profiler window."""

import pytest

from benchmark.program import OUTSIDE, idle_by_span
from benchmark.reduce import profile_window


class _Event:
    def __init__(self, name, device, start, end, thread=1):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.thread = thread


NAMES = {"loop.frame", "context.update", "uniforms.global", "compiled.call/Presenter"}
EVENTS = [
    _Event("bench.window", False, 100.0, 200.0),
    _Event("bench.window", True, 100.0, 200.0),  # the device's mirror of the benchmark's span
    _Event("ctx.update", False, 101.0, 139.0),  # the benchmark's span: not the program's
    _Event("ctx.update", True, 120.0, 150.0),  # and its mirror: no device operation
    _Event("loop.frame", False, 100.0, 190.0),
    _Event("context.update", False, 102.0, 138.0),
    _Event("uniforms.global", False, 104.0, 130.0),
    _Event("uniforms.global", False, 150.0, 152.0, thread=2),  # another thread's
    _Event("compiled.call/Presenter", False, 160.0, 185.0),
    _Event("march_bonsai_kernel", True, 110.0, 120.0),
    _Event("present_kernel", True, 140.0, 170.0),
    _Event("aten::add", False, 105.0, 106.0),  # a host operation, in no list of names
]


def test_gaps_go_to_the_innermost_span():
    idle = idle_by_span(EVENTS, NAMES)
    # gaps 100-110, 120-140, 170-200: 100-102 loop.frame, 102-104 context.update,
    # 104-110 uniforms.global; 120-130 uniforms.global, 130-138 context.update,
    # 138-140 loop.frame; 170-185 compiled.call/Presenter, 185-190 loop.frame, 190-200 outside
    want = {"loop.frame": 2 + 2 + 5, "context.update": 2 + 8, "uniforms.global": 6 + 10,
            "compiled.call/Presenter": 15, OUTSIDE: 10}
    assert idle.keys() == want.keys()
    for k, us in want.items():
        assert idle[k] == pytest.approx(us * 1e-6, abs=1e-12), k
    prof = profile_window(EVENTS)
    assert sum(idle.values()) == pytest.approx(prof["window_s"] - prof["busy_s"], abs=1e-12)


def test_without_program_spans_every_gap_is_outside():
    idle = idle_by_span(EVENTS, set())
    assert idle.keys() == {OUTSIDE} and idle[OUTSIDE] == pytest.approx(60e-6, abs=1e-12)
    assert idle_by_span(EVENTS[2:], NAMES) is None  # no window
    assert idle_by_span([e for e in EVENTS if e.name != "present_kernel"
                         and e.name != "march_bonsai_kernel"], NAMES) is None
