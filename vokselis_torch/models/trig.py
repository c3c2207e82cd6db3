"""Trig demo: one camera-transformed triangle (examples/trig.rs:74-130).

The BasicPipeline render pass (clear to black, draw 3 vertices through
proj_view with FS color ``(fract(time), mouse_pressed, 1, 1)``,
shaders/shader_with_camera.wgsl:26-45) becomes a plain-torch rasterize call
into the HDR backbuffer on the context's device. It launches no kernel of
the port. On a card the frame replays a CUDA graph, one per backbuffer size
(:func:`trig_frame` is the eager frame).
"""

from __future__ import annotations

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.core.colors import fract
from vokselis_torch.engine.compiled import CompiledFrame
from vokselis_torch.engine.demo import Demo
from vokselis_torch.ops.raster import rasterize_triangle

# shader_with_camera.wgsl:29-37
_V0 = (-0.5, -0.5, 0.0)
_V1 = (0.5, -0.5, 0.0)
_V2 = (0.0, 0.5, 0.0)


def trig_frame(proj_view, time, mouse_pressed, width: int, height: int):
    """The demo's triangle through ``proj_view`` in the colour of ``time`` and
    ``mouse_pressed`` (the global uniform's 0-d tensors)."""
    one = torch.ones_like(time)
    color = torch.stack([fract(time), mouse_pressed.to(torch.float32), one, one])
    return rasterize_triangle(proj_view, _V0, _V1, _V2, color, width, height)


class TrigDemo(Demo):
    def __init__(self):
        self.compiled = CompiledFrame("TrigDemo")

    @classmethod
    def init(cls, ctx):
        return cls()

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # trig passes None; Context uses the default pose (src/context.rs:124)
        return Camera.default(aspect)

    def render(self, ctx):
        un = ctx.global_uniform
        bb = ctx.render_backbuffer
        w, h = bb.width, bb.height

        def fn(proj_view, time, mouse_pressed):
            return trig_frame(proj_view, time, mouse_pressed, w, h)

        bb.store(self.compiled(("trig", w, h), fn,
                               (ctx.camera_uniform.proj_view, un.time, un.mouse_pressed)))
