"""Bonsai demo: fragment-raymarch of the 256^3 uint8 CT volume
(examples/bonsai/main.rs:10-76).

Renders with the hand-written kernels on a CUDA context and with their
plain versions on a CPU context (the choice follows ``ctx.device``):
``renderer="exact"`` is the march kernel, ``renderer="fast"`` the shear-warp
approximation (resample, composite and warp kernels). The render output
already applies linear_to_srgb (raycast_naive.wgsl:121-124); the present
pass then tonemaps on top, exactly like the reference's two-stage chain.
"""

from __future__ import annotations

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.demo import Demo
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.shear_warp import FastBonsaiRenderer
from vokselis_torch.volume.io import get_bonsai


class BonsaiDemo(Demo):
    def __init__(self, renderer, vol):
        self.renderer = renderer
        self.vol = vol

    @classmethod
    def init(cls, ctx, renderer: str = "exact"):
        """``renderer``: "exact" (the oracle-parity march kernel) or "fast"
        (the shear-warp approximation at intermediate I=512). The JAX
        package's "hybrid" renderer is not ported yet."""
        if renderer == "hybrid":
            raise NotImplementedError(
                'renderer="hybrid" is not ported to vokselis_torch yet '
                "(ROADMAP.md queue 1, item 6)"
            )
        if renderer not in ("exact", "fast"):
            raise ValueError(f"unknown renderer {renderer!r}")
        vol = get_bonsai()
        cls_r = FastBonsaiRenderer if renderer == "fast" else BonsaiRenderer
        return cls(cls_r(vol, ctx.device), vol)

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/bonsai/main.rs:68-73
        return Camera.bonsai(aspect)

    def render(self, ctx):
        bb = ctx.render_backbuffer
        img = self.renderer(ctx.camera_uniform, bb.width, bb.height)
        bb.store(img)
