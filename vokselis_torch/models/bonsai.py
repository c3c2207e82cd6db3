"""Bonsai demo: fragment-raymarch of the 256^3 uint8 CT volume
(examples/bonsai/main.rs:10-76).

Renders with the hand-written kernels on a CUDA context and with their
plain versions on a CPU context (the choice follows ``ctx.device``):
``renderer="exact"`` is the march kernel, ``renderer="fast"`` the shear-warp
approximation (resample, composite and warp kernels) and
``renderer="hybrid"`` the fast frame with its worst tiles re-marched exactly
(resample, composite, stats warp and tile re-march kernels). The render
output already applies linear_to_srgb (raycast_naive.wgsl:121-124); the
present pass then tonemaps on top, exactly like the reference's two-stage
chain.
"""

from __future__ import annotations

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.demo import Demo
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import FastBonsaiRenderer
from vokselis_torch.volume.io import get_bonsai

RENDERERS = {"exact": BonsaiRenderer, "fast": FastBonsaiRenderer,
             "hybrid": HybridBonsaiRenderer}


class BonsaiDemo(Demo):
    def __init__(self, renderer, vol):
        self.renderer = renderer
        self.vol = vol

    @classmethod
    def init(cls, ctx, renderer: str = "exact"):
        """``renderer``: "exact" (the oracle-parity march kernel), "fast"
        (the shear-warp approximation at intermediate I=512) or "hybrid"
        (the fast frame at I=512 with up to 128 tiles re-marched exactly,
        the JAX package's defaults)."""
        if renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {renderer!r}")
        vol = get_bonsai()
        return cls(RENDERERS[renderer](vol, ctx.device), vol)

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/bonsai/main.rs:68-73
        return Camera.bonsai(aspect)

    def render(self, ctx):
        bb = ctx.render_backbuffer
        img = self.renderer(ctx.camera_uniform, bb.width, bb.height)
        bb.store(img)
