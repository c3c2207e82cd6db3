"""The port's spans and counters (vokselis_torch.engine.profiler: ``span``,
``count``, ``recording``) in its frame loop, uniforms and compiled frames.

On the CPU the frame loop runs a small seeded volume through the exact
renderer's plain version: the frame spans nest as the loop does, self time
never exceeds a span's time, a frame sends one record (the global uniform's
words, after the camera's with a dragged camera), nothing is kept or
counted without a recording, and under a ``torch.profiler`` session the
spans are ranges of the trace nested in ``loop.frame``. The xor demo's
``PassTimer`` reports in a span of its own and counts its one wait on the
card (``host_syncs``, with a stand-in for CUDA events), and its field
pipeline counts its rays.

Tests marked ``gpu`` need a CUDA card and skip without one: a replayed
compiled frame's spans, K1 starting inside its replay's range, and no
device event of a profile bearing a span's name (so the benchmark's
``profile_window`` reads the same with the program's spans as without
them). On the card run ``python -m pytest tests/test_torch_spans.py
--noconftest -m gpu``.
"""

import contextlib
import threading

import pytest
import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine import profiler
from vokselis_torch.engine.context import Context
from vokselis_torch.engine.loop import run
from vokselis_torch.models.bonsai import BonsaiDemo
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer

W = H = 24
FRAME_SPANS = ("loop.frame", "context.update", "uniforms.global", "uniforms.camera",
               "uniforms.send")
# frames a card's profile runs before the measured ones: a new session can
# lose its first device records (benchmark/loop.PROFILER_SETTLE_FRAMES)
SETTLE_FRAMES = 8
MEASURED = "test.measured"
GLOBAL_BYTES = 12 + 4 + 8 + 8 + 4 + 4 + 4  # pos, frame, resolution, mouse, pressed, time, dt
CAMERA_BYTES = 16 + 64 + 64  # view_position, proj_view, inv_proj


def _volume(device, n=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, n, n), dtype=torch.uint8, generator=g).to(device)


def _demo(vol, device):
    """A demo class whose ``init`` hands the loop one prepared renderer (its
    set-up happens before a test's recording opens)."""
    demo = BonsaiDemo(BonsaiRenderer(vol, device), vol)

    class Prepared(BonsaiDemo):
        @classmethod
        def init(cls, ctx):
            return demo

    return Prepared


def _events(frames, drag):
    yield {"type": "mouse_move", "x": 10.0, "y": 10.0, "dragging": False}
    for i in range(frames):
        if drag:
            yield {"type": "mouse_move", "x": 12.0 + 2 * i, "y": 10.0, "dragging": True}
        yield None


def _context(device):
    cam = Camera(zoom=1.5, pitch=0.4, yaw=0.8, target=(0.5, 0.5, 0.5), aspect=1.0)
    ctx = Context(W, H, camera=cam, backbuffer_resolution=(W, H), device=device)
    ctx.camera.updated = False  # its uniform was made with the context
    return ctx


def _run(device, frames, drag=True, record=True):
    demo = _demo(_volume(device), device)
    ctx = _context(device)
    if not record:
        run(demo, frames=frames, events=_events(frames, drag), context=ctx, quiet=True)
        return None
    with profiler.recording() as rec:
        run(demo, frames=frames, events=_events(frames, drag), context=ctx, quiet=True)
    return rec


def test_frame_spans_nest_as_the_loop_does():
    rec = _run("cpu", 3)
    snap = rec.snapshot()
    spans = snap["spans"]
    assert set(FRAME_SPANS) <= set(spans)
    assert spans["loop.frame"]["n"] == 3 and spans["context.update"]["n"] == 3
    assert spans["loop.frame"]["parent"] is None
    assert spans["context.update"]["parent"] == "loop.frame"
    assert spans["uniforms.global"]["parent"] == "context.update"
    assert spans["uniforms.camera"]["parent"] == "context.update"
    assert spans["uniforms.send"]["parent"] == "context.update"
    for key, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["total_s"], key
        assert 0.0 < s["p95_s"] <= s["total_s"], key
    frames = rec.by_id("loop.frame")
    assert sorted(frames) == [0, 1, 2]
    # a span without an id takes its frame's
    assert sorted(rec.by_id("uniforms.global")) == [0, 1, 2]
    assert abs(sum(frames.values()) - spans["loop.frame"]["total_s"]) < 1e-9


@pytest.mark.parametrize("drag, uploads, nbytes", [
    (True, 1, GLOBAL_BYTES + CAMERA_BYTES),
    (False, 1, GLOBAL_BYTES),
])
def test_uploads_a_frame(drag, uploads, nbytes):
    """One record a frame: the global uniform's 11 words, after the
    camera's 36 when a drag dirtied it."""
    rec = _run("cpu", 4, drag=drag)
    snap = rec.snapshot()
    assert snap["counters"] == {"uploads": 4 * uploads, "upload_bytes": 4 * nbytes}
    assert ("uniforms.camera" in snap["spans"]) is drag


def test_nothing_is_kept_without_a_recording():
    assert profiler.span("loop.frame") is profiler.NOOP
    assert profiler.span("compiled.call", "BonsaiRenderer", 3) is profiler.NOOP
    _run("cpu", 2, record=False)
    profiler.count("uploads", 5)
    with profiler.recording() as rec:
        pass
    assert rec.snapshot() == {"spans": {}, "counters": {}}
    assert profiler.span("loop.frame") is profiler.NOOP


def test_self_time_is_the_time_children_leave():
    with profiler.recording() as rec:
        with profiler.span("outer", id=7):
            for tag in ("a", "b", "a"):
                with profiler.span("inner", tag):
                    with profiler.span("leaf"):
                        sum(range(1000))
        with profiler.span("outer", id=8):
            pass
    s = rec.snapshot()["spans"]
    assert s["outer"]["n"] == 2 and s["inner/a"]["n"] == 2 and s["inner/b"]["n"] == 1
    assert s["inner/a"]["parent"] == "outer" and s["leaf"]["parent"] == "inner/a"
    children = s["inner/a"]["total_s"] + s["inner/b"]["total_s"]
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["total_s"] - children, abs=1e-12)
    assert s["leaf"]["self_s"] == s["leaf"]["total_s"]
    assert sorted(rec.by_id("leaf")) == [7]
    assert sorted(rec.by_id("outer")) == [7, 8]


def test_other_threads_and_a_second_recording():
    """Only the recording thread's spans and counts are kept (the source
    watcher's thread is not); one recording at a time."""
    with profiler.recording() as rec:
        def other():
            with profiler.span("watcher"):
                profiler.count("uploads")

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with profiler.recording():
                pass
        profiler.count("uploads", 2)
    assert rec.snapshot() == {"spans": {}, "counters": {"uploads": 2}}


class _Event:
    """A stand-in for ``torch.cuda.Event`` on a machine without a card."""

    synced = 0

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        _Event.synced += 1

    def elapsed_time(self, end):
        return 0.5


def _timed_frames(timer, frames):
    for f in range(frames):
        with profiler.span("loop.frame", id=f):
            with timer.measure(n_rays=6):
                pass


@pytest.mark.parametrize("device, syncs", [("cuda", 2), ("cpu", 0)])
def test_pass_timer_report_is_a_span_and_counts_its_sync(device, syncs, monkeypatch, capsys):
    """A report every ``report_every`` passes: a span in the frame that
    reports, and on a card one ``host_syncs`` for the one wait on the
    device (the CPU times by the wall clock and waits for nothing)."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "synced", 0)
    timer = profiler.PassTimer("raycast shader", report_every=4, device=device)
    with profiler.recording() as rec:
        _timed_frames(timer, 10)
    snap = rec.snapshot()
    assert snap["counters"] == ({"host_syncs": syncs} if syncs else {})
    assert _Event.synced == syncs
    report = snap["spans"]["pass_timer.report"]
    assert report["n"] == 2 and report["parent"] == "loop.frame"
    assert sorted(rec.by_id("pass_timer.report")) == [3, 7]
    assert capsys.readouterr().out.count("Time on raycast shader") == 2


def test_pass_timer_keeps_nothing_without_a_recording(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "synced", 0)
    timer = profiler.PassTimer("raycast shader", report_every=4, device="cuda")
    _timed_frames(timer, 8)
    assert _Event.synced == 2 and capsys.readouterr().out.count("Time on") == 2
    assert profiler.span("pass_timer.report") is profiler.NOOP
    with profiler.recording() as rec:
        pass
    assert rec.snapshot() == {"spans": {}, "counters": {}}


def test_field_pipeline_counts_its_rays():
    from vokselis_torch.models.xor import FieldPipeline

    pipe = FieldPipeline("cpu", grad="analytic", dims=16)
    cam = Camera.xor(aspect=8 / 6).uniform("cpu")
    with profiler.recording() as rec:
        for _ in range(2):
            pipe.render(cam, 0.5, 8, 6)
    assert rec.snapshot()["counters"] == {"field.rays": 2 * 8 * 6}
    pipe.render(cam, 0.5, 8, 6)  # nothing counted without a recording


def _profiled_frames(device, frames, record):
    demo = _demo(_volume(device), device)
    ctx = _context(device)
    run(demo, frames=1, events=_events(1, True), context=ctx, quiet=True)  # captures on a card
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if device != "cpu":
            run(demo, frames=SETTLE_FRAMES, events=_events(SETTLE_FRAMES, True), context=ctx,
                quiet=True)
            torch.cuda.synchronize()
        with torch.profiler.record_function(MEASURED):
            with profiler.recording() if record else contextlib.nullcontext() as rec:
                run(demo, frames=frames, events=_events(frames, True), context=ctx, quiet=True)
        if device != "cpu":
            torch.cuda.synchronize()
    events = prof.events()
    t0 = min(e.time_range.start for e in events if e.name == MEASURED)
    return [e for e in events if e.time_range.start >= t0], rec


@pytest.mark.parametrize("record", [False, True])
def test_spans_are_ranges_under_the_profiler(record):
    events, rec = _profiled_frames("cpu", 2, record)
    ranges = [e for e in events if e.name in FRAME_SPANS]
    assert sum(e.name == "loop.frame" for e in ranges) == 2
    for e in ranges:
        if e.name == "loop.frame":
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != "loop.frame":
            parent = parent.cpu_parent
        assert parent is not None, e.name
    assert {e.name for e in ranges} == set(FRAME_SPANS)
    if record:
        assert rec.snapshot()["spans"]["loop.frame"]["n"] == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_replay_is_split_into_its_steps_on_gpu(cuda_device):
    from vokselis_torch.models.views import ViewsBatch

    r = BonsaiRenderer(_volume(cuda_device, 32), cuda_device)
    u = Camera.bonsai(1.0).uniform(cuda_device)
    r(u, 64, 64)  # the capture
    with profiler.recording() as rec:
        r(u, 64, 64)
    spans = rec.snapshot()["spans"]
    steps = ("compiled.copy_in", "compiled.replay", "compiled.copy_out")
    assert set(spans) == {"compiled.call/BonsaiRenderer"} | {f"{s}/BonsaiRenderer" for s in steps}
    for s in steps:
        assert spans[f"{s}/BonsaiRenderer"]["parent"] == "compiled.call/BonsaiRenderer"
    with profiler.recording() as rec:
        r(u, 48, 48)  # a new key: captured, not replayed
    spans = rec.snapshot()["spans"]
    assert spans["compiled.capture/BonsaiRenderer"]["n"] == 1
    assert spans["compiled.capture/BonsaiRenderer"]["parent"] == "compiled.call/BonsaiRenderer"
    assert "compiled.replay/BonsaiRenderer" not in spans

    vb = ViewsBatch(2, 32, 32, device=cuda_device)
    vb(4)
    with profiler.recording() as rec:
        vb(5)
    assert list(rec.by_id("compiled.call/ViewsBatch")) == [5]
    assert list(rec.by_id("compiled.replay/ViewsBatch")) == [5]


@pytest.mark.gpu
def test_k1_starts_inside_its_replay_range_on_gpu(cuda_device):
    events, _ = _profiled_frames(cuda_device, 3, record=False)
    replays = sorted(e.time_range.start for e in events
                     if e.name == "compiled.replay/BonsaiRenderer"
                     and e.device_type == torch.autograd.DeviceType.CPU)
    k1 = sorted(e.time_range.start for e in events
                if "march_bonsai_kernel" in e.name
                and e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(replays) == 3 and len(k1) == 3
    for r0, k0 in zip(replays, k1):
        assert k0 >= r0


@pytest.mark.gpu
@pytest.mark.parametrize("record", [False, True])
def test_no_device_event_bears_a_span_name_on_gpu(cuda_device, record):
    """The spans are host ranges only: no device event is named by one, so
    ``benchmark.reduce.profile_window`` reads the same busy time, operations
    and gaps with them as without them."""
    from benchmark.reduce import WINDOW_SPAN, profile_window

    demo = _demo(_volume(cuda_device, 32), cuda_device)
    ctx = _context(cuda_device)
    run(demo, frames=1, events=_events(1, True), context=ctx, quiet=True)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        with profiler.recording() if record else contextlib.nullcontext():
            with torch.profiler.record_function(WINDOW_SPAN):
                run(demo, frames=4, events=_events(4, True), context=ctx, quiet=True)
                torch.cuda.synchronize()
    events = prof.events()
    names = set(FRAME_SPANS)
    names |= {f"compiled.{s}/{n}" for s in ("call", "copy_in", "replay", "copy_out", "capture")
              for n in ("BonsaiRenderer", "Presenter")}
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"loop.frame", "compiled.replay/BonsaiRenderer", "compiled.call/Presenter"} <= host
    device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device and not names & set(device)
    assert profile_window(events) == profile_window([e for e in events if e.name not in names])
