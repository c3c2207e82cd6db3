"""Trig demo: one camera-transformed triangle (examples/trig.rs:74-130).

The BasicPipeline render pass (clear to black, draw 3 vertices through
proj_view with FS color ``(fract(time), mouse_pressed, 1, 1)``,
shaders/shader_with_camera.wgsl:26-45) becomes a plain-torch rasterize call
into the HDR backbuffer on the context's device. It launches no kernel of
the port.
"""

from __future__ import annotations

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.core.colors import fract
from vokselis_torch.engine.demo import Demo
from vokselis_torch.ops.raster import rasterize_triangle

# shader_with_camera.wgsl:29-37
_V0 = (-0.5, -0.5, 0.0)
_V1 = (0.5, -0.5, 0.0)
_V2 = (0.0, 0.5, 0.0)


class TrigDemo(Demo):
    @classmethod
    def init(cls, ctx):
        return cls()

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # trig passes None; Context uses the default pose (src/context.rs:124)
        return Camera.default(aspect)

    def render(self, ctx):
        un = ctx.global_uniform
        one = torch.ones_like(un.time)
        color = torch.stack([fract(un.time), un.mouse_pressed.to(torch.float32), one, one])
        bb = ctx.render_backbuffer
        img = rasterize_triangle(ctx.camera_uniform.proj_view, _V0, _V1, _V2, color,
                                 bb.width, bb.height)
        bb.store(img)
