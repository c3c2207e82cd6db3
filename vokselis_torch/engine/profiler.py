"""Frame-time and pass-time profiling.

- :class:`FrameCounter` mirrors src/utils/frame_counter.rs:3-40 — accumulates
  frame time and prints the average every 100 frames; ``time_delta()`` feeds
  the global uniform like context.rs:227.
- :class:`PassTimer` is the analog of the xor demo's GPU timestamp-query pair
  (examples/xor/main.rs:120-131, 164-187): on a CUDA device it brackets a
  pass with CUDA events and reads them only when it reports, every N frames,
  so timing adds no host sync to a frame; on the CPU it takes the wall clock.
  It prints 'Time on raycast shader'-style reports plus a derived Mrays/s.
  (The JAX package calibrated a host dispatch floor instead; events time the
  device itself.)
- :func:`trace` captures a device trace around a block (the JAX package's
  ``jax.profiler.trace``): ``torch.profiler`` with CPU and, where there is
  a card, CUDA activities, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


class FrameCounter:
    def __init__(self, report_every: int = 100):
        self.frame_count = 0
        self.accum_time = 0.0
        self.last_frame_time = time.perf_counter()
        self.report_every = report_every
        self.last_avg_ms = 0.0

    def record(self) -> float:
        """Mark a frame boundary; returns dt seconds. Prints the average
        every ``report_every`` frames (frame_counter.rs:18-28)."""
        now = time.perf_counter()
        dt = now - self.last_frame_time
        self.last_frame_time = now
        self.accum_time += dt
        self.frame_count += 1
        if self.frame_count % self.report_every == 0:
            self.last_avg_ms = self.accum_time / self.report_every * 1000.0
            print(f"Avg frame time {self.last_avg_ms:.2f}ms")
            self.accum_time = 0.0
        return dt

    def time_delta(self) -> float:
        """Average seconds per frame over the current window
        (frame_counter.rs:14-16)."""
        if self.frame_count % self.report_every == 0:
            return self.last_avg_ms / 1000.0 if self.last_avg_ms else 1.0 / 60.0
        n = self.frame_count % self.report_every
        return self.accum_time / max(n, 1)


class PassTimer:
    """Times a named pass on ``device``; prints every ``report_every``
    frames. ``last_ms`` holds the last report's mean ms per pass."""

    def __init__(self, name: str = "raycast shader", report_every: int = 100,
                 device="cpu"):
        self.name = name
        self.report_every = report_every
        self.device = torch.device(device)
        self.count = 0
        self.rays = 0
        self.last_ms = 0.0
        self._accum = 0.0  # seconds (CPU)
        self._events = []  # (start, end) pairs since the last report (CUDA)

    @contextlib.contextmanager
    def measure(self, n_rays: int = 0):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._accum += time.perf_counter() - t0
        self.rays += n_rays
        self.count += 1
        if self.count % self.report_every == 0:
            self._report()

    def _report(self):
        if self._events:
            self._events[-1][1].synchronize()
            ms = sum(s.elapsed_time(e) for s, e in self._events)
        else:
            ms = self._accum * 1000.0
        self.last_ms = ms / self.report_every
        msg = f"Time on {self.name}: {self.last_ms:.3f}ms"
        if self.rays and ms > 0.0:
            msg += f" ({self.rays / (ms * 1e3):.1f} Mrays/s)"
        print(msg)
        self._accum = 0.0
        self._events = []
        self.rays = 0


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``logdir`` (default ``vokselis-trace`` in the temporary directory) as a
    Chrome trace, ``trace_<pid>_<ns>.json``; yields the profiler, whose
    ``trace_path`` names the file once the block ends."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vokselis-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    print(f"profiler trace written to {prof.trace_path}")
