"""The orbit camera and the frame loop's event-to-pose mapping.

A frozen copy of the upstream camera (src/camera.rs:74-172: spherical orbit,
glam's ``look_at_rh`` and ``perspective_rh`` with fovy pi/2, near 0.1, far
100, zoom clamped to [0.3, 50], pitch to the open (-pi/2, pi/2)) and of the
loop's input handling (src/lib.rs:160-174: a drag turns yaw by -dx and pitch
by +dy at 0.0025 rad a pixel, the wheel zooms by -delta at 0.002). Matrices
are float32 on the host, the product and the inverse taken in float64.
"""

from __future__ import annotations

import math

import numpy as np

ZNEAR, ZFAR, FOVY = 0.1, 100.0, math.pi / 2.0
ROTATE_SPEED, ZOOM_SPEED = 0.0025, 0.002
_EPS32 = float(np.finfo(np.float32).eps)


def look_at_rh(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye, target, up = (np.asarray(v, np.float32) for v in (eye, target, up))
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    return np.array([[s[0], s[1], s[2], -float(np.dot(s, eye))],
                     [u[0], u[1], u[2], -float(np.dot(u, eye))],
                     [-f[0], -f[1], -f[2], float(np.dot(f, eye))],
                     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def perspective_rh(fovy: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    h = math.cos(0.5 * fovy) / math.sin(0.5 * fovy)
    r = zfar / (znear - zfar)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2], m[2, 3], m[3, 2] = h / aspect, h, r, r * znear, -1.0
    return m


class Pose:
    """Yaw, pitch and zoom about ``target``, moved as the loop moves them."""

    def __init__(self, yaw: float, pitch: float, zoom: float, target=(0.5, 0.5, 0.5),
                 aspect: float = 1.0):
        self.yaw, self.target, self.aspect = float(yaw), target, aspect
        self.pitch = self._clip_pitch(pitch)
        self.zoom = self._clip_zoom(zoom)

    @staticmethod
    def _clip_pitch(p):
        return float(np.clip(p, -math.pi / 2.0 + _EPS32, math.pi / 2.0 - _EPS32))

    @staticmethod
    def _clip_zoom(z):
        return float(np.clip(z, 0.3, ZFAR / 2.0))

    def apply(self, event: dict, last_mouse):
        """Apply one loop event; returns the new last mouse position."""
        kind = event.get("type")
        if kind == "mouse_move":
            x, y = event["x"], event["y"]
            if event.get("dragging") and last_mouse is not None:
                self.yaw = float(self.yaw + -(x - last_mouse[0]) * ROTATE_SPEED)
                self.pitch = self._clip_pitch(self.pitch + (y - last_mouse[1]) * ROTATE_SPEED)
            return (x, y)
        if kind == "wheel":
            self.zoom = self._clip_zoom(self.zoom + -event["delta"] * ZOOM_SPEED)
        return last_mouse

    def eye(self) -> np.ndarray:
        pc = math.cos(self.pitch)
        offs = np.array([math.sin(self.yaw) * pc, math.sin(self.pitch),
                         math.cos(self.yaw) * pc], dtype=np.float32)
        return np.asarray(self.target, np.float32) - np.float32(self.zoom) * offs

    def matrices(self):
        """``(view_position (4,), inv_proj (4, 4))`` as float32, inv_proj the
        inverse of proj @ view."""
        eye = self.eye()
        view = look_at_rh(tuple(eye.tolist()), self.target)
        proj = perspective_rh(FOVY, self.aspect, ZNEAR, ZFAR)
        pv = (proj.astype(np.float64) @ view.astype(np.float64)).astype(np.float32)
        inv = np.linalg.inv(pv.astype(np.float64)).astype(np.float32)
        return np.array([*eye.tolist(), 1.0], np.float32), inv


def replay(start: Pose, events_by_frame, frames) -> dict:
    """The pose after each frame of ``frames`` (a set of frame indices), the
    events of frame f being ``events_by_frame(f)``, applied in order from
    frame 0; returns ``{frame: (view_position, inv_proj)}``."""
    want, out, last = set(frames), {}, None
    pose = start
    for f in range(max(want) + 1 if want else 0):
        for ev in events_by_frame(f):
            last = pose.apply(ev, last)
        if f in want:
            out[f] = pose.matrices()
    return out
