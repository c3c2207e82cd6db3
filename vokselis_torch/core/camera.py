"""Orbit camera producing ``proj_view`` / ``inv_proj`` matrices as tensors.

Rebuilds the reference's spherical-orbit camera (src/camera.rs:74-172) with the
same parametrization, clamps and matrix conventions so pixel-level comparisons
hold:

- eye placement: ``eye = target - zoom * (sin(yaw)*cos(pitch), sin(pitch),
  cos(yaw)*cos(pitch))``  (src/camera.rs:148-157)
- zoom clamped to ``[0.3, ZFAR/2]`` (src/camera.rs:116), pitch clamped to the
  open interval ``(-pi/2, pi/2)`` (src/camera.rs:126-129)
- projection: glam's ``Mat4::perspective_rh`` (wgpu 0..1 depth) with
  ``fovy = pi/2, znear = 0.1, zfar = 100`` (src/camera.rs:88-91,109-113)
- view: glam's ``Mat4::look_at_rh``
- uniform payload: ``{view_position: vec4, proj_view: mat4, inv_proj: mat4}``
  where ``inv_proj`` is the inverse of ``proj @ view`` (src/camera.rs:164-171).

Matrices are built on the host in numpy (row-major: ``clip = proj_view @
[p, 1]``) and handed to the device once per camera change as a
:class:`CameraUniform` of float32 tensors, uploaded without a synchronizing
copy. :meth:`Camera.uniform` also attaches the host arrays as ``host_np``
(the JAX package's host mirrors), so that host-side pose classification
reads no device value.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from vokselis_torch.core.uniforms import upload

ZFAR = 100.0
ZNEAR = 0.1
FOVY = math.pi / 2.0
UP = (0.0, 1.0, 0.0)

_EPS32 = float(np.finfo(np.float32).eps)


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (row-major), matching glam.

    glam stores column-major; this returns the row-major equivalent M such
    that ``view_space = M @ [p, 1]``.
    """
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.array(
        [
            [s[0], s[1], s[2], -float(np.dot(s, eye))],
            [u[0], u[1], u[2], -float(np.dot(u, eye))],
            [-f[0], -f[1], -f[2], float(np.dot(f, eye))],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return m


def perspective_rh(fovy: float, aspect: float, znear: float, zfar: float):
    """glam ``Mat4::perspective_rh`` (0..1 depth range, wgpu convention), row-major."""
    sin_fov = math.sin(0.5 * fovy)
    cos_fov = math.cos(0.5 * fovy)
    h = cos_fov / sin_fov
    w = h / aspect
    r = zfar / (znear - zfar)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * znear
    m[3, 2] = -1.0
    return m


@dataclass
class CameraUniform:
    """Device-side camera payload (mirrors CameraUniform, src/camera.rs:7-21):
    three float32 tensors on one device.

    A batch of views carries a leading (V,) axis on each tensor, as the JAX
    package's stacked pytree does (``vokselis_tpu/parallel/sharding.py``
    ``orbit_camera_batch``): :meth:`stack` builds one, ``len`` counts its
    views, an int index gives one view's unbatched uniform and a slice a
    batch of a block of views.

    ``host_np`` is ``(view_position, proj_view, inv_proj)`` as the float32
    numpy arrays the tensors were uploaded from, or None. Only
    :meth:`Camera.uniform` attaches it (the JAX package's
    ``vokselis_tpu/core/camera.py:178-182``); :meth:`from_numpy`,
    :meth:`stack` and indexing give uniforms without it, as the JAX
    package's rebuilt uniforms lack it."""

    view_position: torch.Tensor  # (4,) eye.xyz, 1; (V, 4) batched
    proj_view: torch.Tensor  # (4, 4) row-major; (V, 4, 4) batched
    inv_proj: torch.Tensor  # (4, 4) inverse of proj_view (name kept from reference)
    host_np: tuple | None = field(default=None, repr=False, compare=False)

    @classmethod
    def from_numpy(cls, view_position, proj_view, inv_proj, device):
        """Upload host arrays (e.g. another renderer's camera state, one view
        or a stacked batch) as the float32 payload on ``device``, without a
        synchronizing copy (:func:`vokselis_torch.core.uniforms.upload`)."""
        return cls(*(upload(np.asarray(x, np.float32), device)
                     for x in (view_position, proj_view, inv_proj)))

    @classmethod
    def stack(cls, uniforms):
        """One batched uniform of the unbatched ``uniforms``, in order."""
        uniforms = list(uniforms)
        if not uniforms or any(u.batched for u in uniforms):
            raise ValueError("stack takes one or more unbatched uniforms")
        return cls(*(torch.stack([getattr(u, name) for u in uniforms])
                     for name in ("view_position", "proj_view", "inv_proj")))

    def tensors(self) -> tuple:
        """``(view_position, proj_view, inv_proj)``: what a compiled frame
        copies into its graph's static inputs."""
        return self.view_position, self.proj_view, self.inv_proj

    @property
    def batched(self) -> bool:
        """Whether the tensors carry a leading view axis."""
        return self.view_position.ndim == 2

    def __len__(self) -> int:
        if not self.batched:
            raise TypeError("an unbatched CameraUniform has no len()")
        return self.view_position.shape[0]

    def __getitem__(self, index):
        if not self.batched:
            raise TypeError("an unbatched CameraUniform cannot be indexed")
        return CameraUniform(self.view_position[index], self.proj_view[index],
                             self.inv_proj[index])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @classmethod
    def identity(cls, device):
        eye4 = np.eye(4, dtype=np.float32)
        return cls.from_numpy(np.zeros(4, np.float32), eye4, eye4, device)


@dataclass
class Camera:
    """Host-side orbit camera state (mirrors Camera, src/camera.rs:74-172).

    Mutating setters mirror the reference's clamp semantics and mark the
    camera dirty (``updated``) so the engine can skip uniform rebuilds.
    """

    zoom: float = 1.0
    pitch: float = 0.5
    yaw: float = 1.0
    target: tuple = (0.0, 0.0, 0.0)
    aspect: float = 16.0 / 9.0
    up: tuple = UP
    eye: tuple = field(default=(0.0, 0.0, 0.0), init=False)
    updated: bool = field(default=False, init=False)

    def __post_init__(self):
        self._fix_eye()

    # --- setters (src/camera.rs:115-146) -------------------------------
    def set_zoom(self, zoom: float):
        self.zoom = float(np.clip(zoom, 0.3, ZFAR / 2.0))
        self._fix_eye()
        self.updated = True

    def add_zoom(self, delta: float):
        self.set_zoom(self.zoom + delta)

    def set_pitch(self, pitch: float):
        self.pitch = float(
            np.clip(pitch, -math.pi / 2.0 + _EPS32, math.pi / 2.0 - _EPS32)
        )
        self._fix_eye()
        self.updated = True

    def add_pitch(self, delta: float):
        self.set_pitch(self.pitch + delta)

    def set_yaw(self, yaw: float):
        self.yaw = float(yaw)
        self._fix_eye()
        self.updated = True

    def add_yaw(self, delta: float):
        self.set_yaw(self.yaw + delta)

    def set_aspect(self, width: int, height: int):
        self.aspect = float(width) / float(height)
        self.updated = True

    def _fix_eye(self):
        # src/camera.rs:148-157
        pc = math.cos(self.pitch)
        t = np.asarray(self.target, np.float32)
        offs = np.array(
            [math.sin(self.yaw) * pc, math.sin(self.pitch), math.cos(self.yaw) * pc],
            dtype=np.float32,
        )
        self.eye = tuple((t - np.float32(self.zoom) * offs).tolist())

    # --- matrices (src/camera.rs:109-113,164-171) -----------------------
    def build_projection_view_matrix(self) -> np.ndarray:
        view = look_at_rh(self.eye, self.target, self.up)
        proj = perspective_rh(FOVY, self.aspect, ZNEAR, ZFAR)
        return (proj.astype(np.float64) @ view.astype(np.float64)).astype(np.float32)

    def uniform(self, device) -> CameraUniform:
        """This pose's :class:`CameraUniform` on ``device``, with its host
        mirrors ``host_np`` attached."""
        pv = self.build_projection_view_matrix()
        inv = np.linalg.inv(pv.astype(np.float64)).astype(np.float32)
        vp = np.asarray(
            [self.eye[0], self.eye[1], self.eye[2], 1.0], np.float32
        )
        u = CameraUniform.from_numpy(vp, pv, inv, device)
        # host mirrors: pose_hint reads these instead of the device
        u.host_np = (vp, pv, inv)
        return u

    # convenience: the reference per-demo poses
    @classmethod
    def default(cls, aspect=16.0 / 9.0):
        """Context::new fallback camera (src/context.rs:124-132)."""
        return cls(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.0, 0.0, 0.0), aspect=aspect)

    @classmethod
    def bonsai(cls, aspect=16.0 / 9.0):
        """examples/bonsai/main.rs:68-73."""
        return cls(zoom=1.0, pitch=0.5, yaw=1.0, target=(0.5, 0.5, 0.5), aspect=aspect)

    @classmethod
    def xor(cls, aspect=16.0 / 9.0):
        """examples/xor/main.rs:270-276."""
        return cls(zoom=3.0, pitch=-0.5, yaw=1.0, target=(0.0, 0.0, 0.0), aspect=aspect)
