"""Render context: device handle, framebuffers, per-frame state, present.

Rebuilds the reference's Context (src/context.rs:38-359) for PyTorch:

- the wgpu instance/adapter/device/queue becomes a ``torch.device`` given
  by the caller (``renderer_info`` mirrors the RendererInfo startup banner,
  context.rs:183-223);
- the HDR backbuffer is a fixed-resolution f32 framebuffer tensor on that
  device (HdrBackBuffer, src/context/hdr_backbuffer.rs:10-11 — default
  1280x720 regardless of window size, faithfully kept);
- ``update()`` refreshes the global uniform (time/dt/frame/resolution +
  input, context.rs:225-236) and the camera uniform when dirty
  (camera.rs:62-71): one record a frame, sent without a synchronizing copy;
- ``render()`` is the present pass: ACES + sRGB into the window-sized
  display image AND the rgb capture image — one op returning identical
  bytes for both targets (context.rs:251-297), replayed from a CUDA graph
  on a card (:class:`Presenter`);
- ``capture_frame()`` is the screenshot path: uint8 quantize + host copy
  (src/context/screenshot.rs:37-77 — no 256-byte row padding needed here,
  but ImageDimensions keeps the even-dimension rule for encoders);
- ``shader_compiler`` and ``watcher`` are the shader hot-reload pair (the
  reference's ShaderCompiler and Watcher, src/watcher.rs): demos register
  their kernel or field sources with the watcher, whose thread runs only
  with ``watch=True``.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from vokselis_torch.core.camera import CAMERA_WORDS, Camera, CameraUniform
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.core.config import DEFAULT_RESOLUTION, EngineConfig
from vokselis_torch.core.uniforms import GlobalUniform, send
from vokselis_torch.engine.compiler import KernelCompiler
from vokselis_torch.engine.input import Input
from vokselis_torch.engine.profiler import span
from vokselis_torch.engine.reload import Watcher
from vokselis_torch.ops.present import FILTERS, present, to_uint8
from vokselis_torch.utils.misc import ImageDimensions


class HdrBackBuffer:
    """Offscreen HDR render target (src/context/hdr_backbuffer.rs).

    Fixed default resolution 1280x720 independent of window size
    (hdr_backbuffer.rs:10-11); stored f32 (the Rgba16Float analog — we render
    f32 and let capture quantize, SURVEY.md §7 'f16 accumulation')."""

    DEFAULT_RESOLUTION = DEFAULT_RESOLUTION

    def __init__(self, device, resolution=DEFAULT_RESOLUTION):
        self.width, self.height = resolution
        self.texture = torch.zeros((self.height, self.width, 4),
                                   dtype=torch.float32, device=device)

    @property
    def resolution(self):
        return (self.width, self.height)

    def store(self, img):
        if img.shape != self.texture.shape or img.device != self.texture.device:
            raise ValueError(
                f"demo rendered {tuple(img.shape)} on {img.device}, backbuffer "
                f"is {tuple(self.texture.shape)} on {self.texture.device}"
            )
        self.texture = img


class Presenter:
    """:func:`vokselis_torch.ops.present.present` and ``to_uint8`` as
    compiled frames (the JAX package jits both): on a card each call
    replays a CUDA graph, one per ``(out_height, out_width, tonemap,
    filter)`` and input shape, and returns a fresh image; elsewhere it
    calls the function. The module functions are the eager passes."""

    def __init__(self):
        self.compiled = CompiledFrame("Presenter")

    def __call__(self, hdr, out_height: int | None = None, out_width: int | None = None,
                 tonemap: bool = True, filter: str = "linear"):
        if filter not in FILTERS:
            raise ValueError(f"filter must be one of {tuple(FILTERS)}, got {filter!r}")
        out_h = out_height or hdr.shape[0]
        out_w = out_width or hdr.shape[1]

        def fn(x):
            return present(x, out_h, out_w, tonemap, filter)

        return self.compiled(("present", out_h, out_w, bool(tonemap), filter), fn, (hdr,))

    def to_uint8(self, img):
        return self.compiled(("to_uint8",), to_uint8, (img,))


def renderer_info(device) -> str:
    """Startup banner (RendererInfo, src/context.rs:183-223,319-337)."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        name, count = device.type, 1
    lines = [
        "Renderer information:",
        f"\tVendor name: {name}",
        f"\tDevice: {device}",
        f"\tBackend: torch {torch.__version__}"
        + (f", CUDA {torch.version.cuda}" if device.type == "cuda" else ""),
        f"\tDevices on host: {count}",
    ]
    return "\n".join(lines)


class Context:
    """Owns device-facing state and the per-frame update/present cycle.

    ``device`` (required) is where every frame tensor lives: "cuda" runs the
    hand-written kernels, "cpu" their plain versions. ``watch=True`` starts
    the source watcher's thread: edits to registered kernel sources rebuild
    and swap them mid-run."""

    def __init__(
        self,
        width: int = DEFAULT_RESOLUTION[0],
        height: int = DEFAULT_RESOLUTION[1],
        camera: Camera | None = None,
        config: EngineConfig | None = None,
        backbuffer_resolution=None,
        watch: bool = False,
        *,
        device,
    ):
        self.device = torch.device(device)
        self.config = config or EngineConfig()
        self.width, self.height = width, height
        # default camera pose: src/context.rs:124-132
        self.camera = camera or Camera.default(aspect=width / height)
        self.camera_uniform: CameraUniform = self.camera.uniform(self.device)
        self.global_uniform = GlobalUniform.default(self.device)
        self.render_backbuffer = HdrBackBuffer(
            self.device, backbuffer_resolution or HdrBackBuffer.DEFAULT_RESOLUTION
        )
        self.display_image = None  # last presented frame (window-sized)
        self.presenter = Presenter()
        self.shader_compiler = KernelCompiler()
        self.watcher = Watcher(autostart=watch, compiler=self.shader_compiler)
        self.input = Input()
        self.dims = ImageDimensions.new(width, height)
        self._start_time = _time.perf_counter()
        self.frame = 0

    # --- per-frame state (context.rs:225-236) ----------------------------
    def update(self, time_delta: float | None = None, time: float | None = None):
        with span("context.update"):
            if time is None:
                time = _time.perf_counter() - self._start_time
            if time_delta is None:
                time_delta = 1.0 / 60.0
            g = self.global_uniform
            with span("uniforms.global"):
                mirror = g.mirrored(
                    time=time,
                    time_delta=time_delta,
                    frame=self.frame,
                    resolution=(float(self.render_backbuffer.width),
                                float(self.render_backbuffer.height)),
                    **self.input.position_fields(g),
                )
            cam = None
            if self.camera.updated:
                with span("uniforms.camera"):
                    cam = self.camera.host_uniform()
                self.camera.updated = False
            # the frame's one record: the camera's words (when dirty), then the globals
            with span("uniforms.send"):
                block = send((*cam, mirror) if cam else (mirror,), self.device)
                if cam:
                    self.camera_uniform = CameraUniform.from_block(block)
                    self.camera_uniform.host_np = cam
                self.global_uniform = GlobalUniform(block, mirror, CAMERA_WORDS if cam else 0)
            self.frame += 1

    # --- resize (context.rs:238-249): window resizes; backbuffer doesn't --
    def resize(self, width: int, height: int):
        self.width, self.height = width, height
        self.dims = ImageDimensions.new(width, height)
        self.camera.set_aspect(width, height)

    # --- present pass (context.rs:251-297) --------------------------------
    def render(self):
        """Tonemap the backbuffer to the window-sized display image; the
        same bytes serve the capture target. Returns the display image."""
        self.display_image = self.presenter(
            self.render_backbuffer.texture,
            out_height=self.height,
            out_width=self.width,
        )
        return self.display_image

    # --- capture (context.rs:299-302 + screenshot.rs:37-77) --------------
    def capture_frame(self) -> np.ndarray:
        """Blocking device->host readback of the last presented frame as
        uint8 RGBA rows (even-dimension cropped for encoders)."""
        if self.display_image is None:
            self.render()
        frame = self.presenter.to_uint8(self.display_image).cpu().numpy()
        return frame[: self.dims.height, : self.dims.width]
