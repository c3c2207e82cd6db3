"""The frame loop every frame cell runs: the port's own loop, as a user drives it.

``vokselis_torch.engine.loop.run`` runs a demo on a ``Context`` whose window
and backbuffer are the configuration's size. The loop reads its events from
this module's client: at every frame boundary the client waits for the
previous frame's display image, stamps the host clock, and hands the loop
the next frame's events from the traffic's generator; one frame is in
flight, as in an interactive viewer. Frame f's time is the interval between
stamps f and f + 1.

The first ``warmup`` frames of the traffic are set-up (they capture every
graph the path needs); the window then runs for ``seconds``. A traced run
also records CUDA events and host times around each frame's calls into the
demo's render and the present pass, and after the window profiles
:data:`PROFILED_FRAMES` frames with ``torch.profiler``.

``correct`` compares a sample of the window's display images, drawn from
the seed, with the reference's frames of the same poses, worked out again
from the seed and the event stream.

A demo's driver (``benchmark/drivers/<entry>.py``) subclasses
:class:`FrameLoop` and supplies what belongs to the demo: :meth:`demo`,
:attr:`target`, :meth:`kernels`, :meth:`bounds`, :meth:`reference_images`
and :meth:`control_answers`. They run at set-up and after the window, never
inside the client's loop.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import random
import time

import torch

from benchmark import reduce
from benchmark.reference import camera

SAMPLED_FRAMES = 8
PROFILED_FRAMES = 32
PROFILER_SETTLE_FRAMES = 8  # frames under the profiler before its window opens


class _Marks:
    """CUDA events around a frame's render and present calls, and the host
    time at which the present call returned (traced runs only)."""

    def __init__(self):
        self.on = False
        self.frames = []  # (before render, after render, after present, host time)

    def event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def before_render(self):
        if self.on:
            self.frames.append([self.event()])

    def after_render(self):
        if self.on:
            self.frames[-1].append(self.event())

    def after_present(self):
        if self.on:
            self.frames[-1] += [self.event(), time.perf_counter()]


def _classes(demo_cls, marks, traced):
    """The context and demo classes the loop runs: with ``traced``, both
    wrapped in the benchmark's spans and ``marks``."""
    from vokselis_torch.engine.context import Context

    if not traced:
        return Context, demo_cls

    from torch.profiler import record_function

    class TracedDemo(demo_cls):
        def render(self, ctx):
            marks.before_render()
            with record_function("demo.render"):
                super().render(ctx)
            marks.after_render()

    class TracedContext(Context):
        def update(self, *args, **kwargs):
            with record_function("ctx.update"):
                super().update(*args, **kwargs)

        def render(self):
            with record_function("ctx.render"):
                out = super().render()
            marks.after_present()
            return out

    return TracedContext, TracedDemo


class FrameLoop:
    """The frame loop's machinery; a demo's driver supplies the rest."""

    target = (0.5, 0.5, 0.5)
    """The point the orbit camera turns about, for the program's ``Context``
    and the reference's poses alike."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.seed = seed
        self.device = torch.device(device)
        self.path = importlib.import_module(f"benchmark.traffic.{mix['kind']}").make(mix, seed)
        self.width, self.height = cfg["width"], cfg["height"]
        self.answers = []  # (frame, display image) sampled from the window

    # -- what a demo's driver supplies -------------------------------------

    def demo(self):
        """The ``Demo`` subclass to run, whose ``init(ctx)`` builds it over
        the data the benchmark made from the seed."""
        raise NotImplementedError

    def kernels(self) -> dict:
        """``{label: __global__ name}``: the kernels a traced run times."""
        raise NotImplementedError

    def bounds(self, frames) -> dict:
        """``{label: seconds}``: each of :meth:`kernels`' bound, summed over
        ``frames``."""
        raise NotImplementedError

    def reference_images(self, frames, dtype):
        """The reference's (len(frames), height, width, 4) display images of
        ``frames`` (sorted, distinct), its arithmetic in ``dtype``."""
        raise NotImplementedError

    def control_answers(self) -> list:
        """Answers (their outputs None) whose reference the control test
        recomputes in bfloat16 and float32 at the driver's ``CONTROL_SIZE``."""
        raise NotImplementedError

    # -- the machinery -----------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def measure(self, seconds: float, trace: bool, t_start: float) -> dict:
        """Run the loop: set-up, the window, and with ``trace`` the profiled
        frames after it. Returns the run's record."""
        from vokselis_torch.core.camera import Camera
        from vokselis_torch.engine.loop import run

        traced = trace and self.device.type == "cuda"
        marks = _Marks()
        context_cls, demo_cls = _classes(self.demo(), marks, traced)
        yaw, pitch, zoom = self.path.start()
        ctx = context_cls(width=self.width, height=self.height,
                          camera=Camera(zoom=zoom, pitch=pitch, yaw=yaw, target=self.target,
                                        aspect=self.width / self.height),
                          backbuffer_resolution=(self.width, self.height), device=self.device)
        rng = random.Random(self.seed)
        warm = self.path.warmup
        stamps, state = [], {"prof": None, "span": None, "window_end": None, "profiled": None}

        def client():
            f = 0
            while True:
                if f > 0:
                    with _span(traced, "client.wait"):
                        self._sync()
                    now = time.perf_counter()
                    if f == warm:
                        stamps.append(now)
                        marks.on = traced
                    elif f > warm and state["window_end"] is None:
                        stamps.append(now)
                        i = f - 1 - warm  # frame f - 1 is done: sample it
                        if i < SAMPLED_FRAMES:
                            self.answers.append((f - 1, ctx.display_image))
                        else:
                            j = rng.randrange(i + 1)
                            if j < SAMPLED_FRAMES:
                                self.answers[j] = (f - 1, ctx.display_image)
                        if now - stamps[0] >= seconds:
                            state["window_end"] = f
                            marks.on = False
                            if not traced:
                                break
                            state["prof"] = _profiler()
                            state["prof"].start()
                    if state["window_end"] is not None:
                        n = f - state["window_end"]
                        if n == PROFILER_SETTLE_FRAMES:
                            state["span"] = torch.profiler.record_function(reduce.WINDOW_SPAN)
                            state["span"].__enter__()
                            state["profiled"] = f
                        elif n == PROFILER_SETTLE_FRAMES + PROFILED_FRAMES:
                            state["span"].__exit__(None, None, None)
                            state["prof"].stop()
                            break
                yield from self.path.events(f)
                yield None
                f += 1
            yield {"type": "key", "key": "esc", "pressed": True}
            yield None

        run(demo_cls, context=ctx, events=client(), quiet=True)
        rec = {"setup_s": stamps[0] - t_start, "stamps": stamps, "unit": "frame",
               "attempted": len(stamps) - 1,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                     if self.device.type == "cuda" else 0)}
        if traced:
            self._trace_record(rec, marks, state)
        return rec

    def _trace_record(self, rec, marks, state):
        spans = {"host_s": [], "render_s": [], "present_s": []}
        starts = rec["stamps"]
        for (r0, r1, p1, host_end), s in zip(marks.frames, starts):
            spans["host_s"].append(host_end - s)
            spans["render_s"].append(r0.elapsed_time(r1) * 1e-3)
            spans["present_s"].append(r1.elapsed_time(p1) * 1e-3)
        rec["spans"] = spans
        prof = reduce.profile_window(state["prof"].events())
        rec["profile"] = prof
        if prof is None:
            return
        first = state["profiled"]
        rec["profile_units"] = PROFILED_FRAMES
        rec["kernels"] = {label: reduce.kernel(prof, name)
                          for label, name in self.kernels().items()}
        rec["bounds"] = self.bounds(range(first, first + PROFILED_FRAMES))

    def poses(self, frames) -> dict:
        """``{frame: (view_position, inv_proj)}``: the reference's camera
        after each of ``frames``, replayed from the traffic's events."""
        yaw, pitch, zoom = self.path.start()
        start = camera.Pose(yaw, pitch, zoom, target=self.target,
                            aspect=self.width / self.height)
        return camera.replay(start, self.path.events, frames)

    def release(self):
        """Free the program's state; the sampled display images stay."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32) -> list:
        """The reference's display images of the sampled frames, in order."""
        frames = [f for f, _ in self.answers]
        if not frames:
            return []
        order = sorted(set(frames))
        imgs = self.reference_images(order, dtype)
        return [imgs[order.index(f)] for f in frames]

    @staticmethod
    def compare(output, against) -> dict:
        """The number ``correct`` compares for one display image: the largest
        absolute difference of any channel of any pixel."""
        return {"frame_max_err": float((output - against).abs().max())}

    def program_outputs(self) -> list:
        return [img for _, img in self.answers]


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
