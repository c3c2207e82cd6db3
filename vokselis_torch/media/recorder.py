"""Screenshot/video recorder: worker thread + ffmpeg child process.

Same design as the reference (src/utils/recorder.rs:25-217): a background
worker consumes events from an unbounded channel; ``ffmpeg -version`` is
probed at startup and video support degrades gracefully when absent
(recorder.rs:33-46,62-71); video frames are raw RGBA piped to ffmpeg's stdin
(``-framerate 60 -pix_fmt rgba -f rawvideo -i pipe:`` -> x264 crf 15 yuv420p,
recorder.rs:79-127); screenshots are timestamped PNGs (recorder.rs:189-217).

Frames arrive as host numpy arrays (``Context.capture_frame``). The
``backend`` argument picks the frame sink as the JAX package's recorder
does: the native C++ worker (:class:`vokselis_torch.native.NativeRecorder`)
or this module's thread; screenshots are written by this module's thread
with :func:`write_png` either way.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

from vokselis_torch import native
from vokselis_torch.core.config import SCREENSHOTS_FOLDER, VIDEO_FOLDER
from vokselis_torch.media.png import write_png
from vokselis_torch.utils.misc import ImageDimensions, create_folder, green_blink


@dataclass
class RecordEvent:
    """Events understood by the worker (RecordEvent, recorder.rs:18-23)."""

    kind: str  # "start" | "record" | "finish" | "screenshot"
    frame: np.ndarray | None = None
    dims: ImageDimensions | None = None


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%d-%m-%Y-%H-%M-%S")


class Recorder:
    """Host-side frame sink (Recorder, recorder.rs:25-72)."""

    def __init__(self, backend: str = "auto"):
        """``backend``: "native" (the C++ worker-thread recorder; raises if
        its library cannot be built), "python" (this module's thread), or
        "auto" (native when the library builds, python otherwise)."""
        self._queue: "queue.Queue[RecordEvent | None]" = queue.Queue()
        self.ffmpeg_installed = shutil.which("ffmpeg") is not None
        if not self.ffmpeg_installed:
            # recorder.rs:62-71 — degrade to screenshots-only
            print("ffmpeg not found: video recording disabled, screenshots only")
        self._native = native.NativeRecorder() if native.use_native(backend) else None
        self._thread = threading.Thread(
            target=self._worker, name="recorder", daemon=True
        )
        self._thread.start()
        self.is_recording = False

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    # --- producer API (called from the frame loop) ----------------------
    def screenshot(self, frame: np.ndarray, dims: ImageDimensions | None = None):
        self._queue.put(RecordEvent("screenshot", np.asarray(frame), dims))

    def start(self, dims: ImageDimensions):
        if not self.ffmpeg_installed:
            return
        if self._native is not None:
            create_folder(VIDEO_FOLDER)
            out = os.path.join(VIDEO_FOLDER, f"{_timestamp()}.mp4")
            if self._native.start_video(out, dims.width, dims.height, 60):
                print(f"recording video to {out}")
                self.is_recording = True
            return
        self.is_recording = True
        self._queue.put(RecordEvent("start", None, dims))

    def record(self, frame: np.ndarray):
        if not self.is_recording:
            return
        if self._native is not None:
            self._native.push_frame(np.asarray(frame))
            return
        self._queue.put(RecordEvent("record", np.asarray(frame)))

    def finish(self):
        was_recording = self.is_recording
        self.is_recording = False
        if self._native is not None:
            if was_recording:
                self._native.finish_video()
                print("video saved")
            return
        self._queue.put(RecordEvent("finish"))

    def close(self):
        self.finish()
        self._queue.put(None)
        self._thread.join(timeout=5)
        if self._native is not None:
            self._native.close()
            self._native = None

    # --- worker (record_thread, recorder.rs:129-187) ---------------------
    def _worker(self):
        proc: subprocess.Popen | None = None
        while True:
            ev = self._queue.get()
            if ev is None:
                if proc is not None:
                    self._finish_ffmpeg(proc)
                return
            try:
                if ev.kind == "start":
                    proc = self._spawn_ffmpeg(ev.dims)
                elif ev.kind == "record" and proc is not None:
                    frame = _strip_padding(ev.frame)
                    proc.stdin.write(frame.tobytes())
                elif ev.kind == "finish" and proc is not None:
                    self._finish_ffmpeg(proc)
                    proc = None
                elif ev.kind == "screenshot":
                    self._save_screenshot(ev.frame)
            except Exception as e:  # keep the worker alive (recorder.rs:175,181)
                print(f"recorder error: {e}")

    def _spawn_ffmpeg(self, dims: ImageDimensions) -> subprocess.Popen:
        # recorder.rs:79-127
        create_folder(VIDEO_FOLDER)
        out = os.path.join(VIDEO_FOLDER, f"{_timestamp()}.mp4")
        args = [
            "ffmpeg",
            "-framerate", "60",
            "-pix_fmt", "rgba",
            "-f", "rawvideo",
            "-vcodec", "rawvideo",
            "-s", f"{dims.width}x{dims.height}",
            "-i", "pipe:",
            "-c:v", "libx264",
            "-crf", "15",
            "-preset", "slow",
            "-tune", "animation",
            "-pix_fmt", "yuv420p",
            "-an", out,
        ]
        print(f"recording video to {out}")
        return subprocess.Popen(
            args, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    @staticmethod
    def _finish_ffmpeg(proc: subprocess.Popen):
        try:
            proc.stdin.close()
            proc.wait(timeout=30)
            print("video saved")
        except Exception as e:
            print(f"ffmpeg finish error: {e}")

    @staticmethod
    def _save_screenshot(frame: np.ndarray):
        # save_screenshot, recorder.rs:189-217
        create_folder(SCREENSHOTS_FOLDER)
        path = os.path.join(SCREENSHOTS_FOLDER, f"{_timestamp()}.png")
        write_png(path, _strip_padding(frame))
        green_blink()
        print(f"saved screenshot to {path}")


def _strip_padding(frame: np.ndarray) -> np.ndarray:
    """The reference strips 256-byte row padding per chunk (recorder.rs:155-164);
    captured frames are already unpadded, so this is a no-op passthrough kept
    for API parity with padded sources."""
    return np.ascontiguousarray(frame)
