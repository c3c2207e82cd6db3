"""Frame-time profiling.

:class:`FrameCounter` mirrors src/utils/frame_counter.rs:3-40 — accumulates
frame time and prints the average every 100 frames; ``time_delta()`` feeds
the global uniform like context.rs:227. (The JAX package's ``PassTimer`` and
device ``trace`` are not ported yet.)
"""

from __future__ import annotations

import time


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
