"""The drag-orbit event stream: a user holding the mouse button and orbiting.

Each frame one ``mouse_move`` with the button held turns the camera by the
loop's own drag handling (yaw -dx, pitch +dy, 0.0025 rad a pixel): dx is a
constant ``dx_px``, and dy follows a sine that keeps pitch within
+-``pitch_amplitude`` over ``pitch_period`` frames. One ``wheel`` event a
frame holds zoom on a sine between ``zoom_lo`` and ``zoom_hi`` over
``zoom_period`` frames. The start yaw and both phases are drawn from the
seed; the stream is otherwise the same for every seed.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.camera import ROTATE_SPEED, ZOOM_SPEED

X0 = 512.0  # where the drag starts on the screen; only differences matter
TINY = {"warmup_frames": 3}  # the CPU tests' overrides of a mix


class DragOrbit:
    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng([seed, 1])
        self.yaw0, self.pitch_phase, self.zoom_phase = (float(v) for v in
                                                        rng.uniform(0.0, 2.0 * math.pi, 3))
        self.dx = float(mix["dx_px"])
        self.pitch_amp, self.pitch_period = float(mix["pitch_amplitude"]), mix["pitch_period"]
        self.zoom_mid = 0.5 * (mix["zoom_lo"] + mix["zoom_hi"])
        self.zoom_half = 0.5 * (mix["zoom_hi"] - mix["zoom_lo"])
        self.zoom_period = mix["zoom_period"]
        self.warmup = int(mix["warmup_frames"])

    def pitch(self, f: int) -> float:
        return self.pitch_amp * math.sin(2.0 * math.pi * f / self.pitch_period + self.pitch_phase)

    def zoom(self, f: int) -> float:
        return self.zoom_mid + self.zoom_half * math.sin(2.0 * math.pi * f / self.zoom_period
                                                         + self.zoom_phase)

    def start(self) -> tuple:
        """``(yaw, pitch, zoom)`` of the camera before frame 0."""
        return self.yaw0, self.pitch(0), self.zoom(0)

    def events(self, f: int) -> list:
        """The loop events of frame ``f``."""
        move = {"type": "mouse_move", "x": X0 + self.dx * f,
                "y": self.pitch(f) / ROTATE_SPEED, "dragging": True}
        if f == 0:  # press, and the drag's first position
            return [{"type": "mouse_button", "pressed": True}, move]
        return [move, {"type": "wheel", "delta": -(self.zoom(f) - self.zoom(f - 1)) / ZOOM_SPEED}]


def make(mix: dict, seed: int) -> DragOrbit:
    return DragOrbit(mix, seed)
