"""Bonsai demo: fragment-raymarch of the 256^3 uint8 CT volume
(examples/bonsai/main.rs:10-76), or of another volume handed to
:meth:`BonsaiDemo.init`: a uint8 scan or a float32 field (mapped by its
data range), as an array, or an Open SciVis Datasets ``.raw`` file.

Renders with the hand-written kernels on a CUDA context and with their
plain versions on a CPU context (the choice follows ``ctx.device``):
``renderer="exact"`` is the march kernel, ``renderer="fast"`` the shear-warp
approximation (resample, composite and warp kernels) and
``renderer="hybrid"`` the fast frame with its worst tiles re-marched exactly
(resample, composite, stats warp and tile re-march kernels). The exact
renderer takes any (D, H, W) volume, uint8 or float32; fast and hybrid
take uint8 cubes. The render
output already applies linear_to_srgb (raycast_naive.wgsl:121-124); the
present pass then tonemaps on top, exactly like the reference's two-stage
chain.
"""

from __future__ import annotations

import os

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.demo import Demo
from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer
from vokselis_torch.ops.hybrid import HybridBonsaiRenderer
from vokselis_torch.ops.shear_warp import FastBonsaiRenderer
from vokselis_torch.volume.io import get_bonsai, load_open_scivis

RENDERERS = {"exact": BonsaiRenderer, "fast": FastBonsaiRenderer,
             "hybrid": HybridBonsaiRenderer}


class BonsaiDemo(Demo):
    def __init__(self, renderer, vol):
        self.renderer = renderer
        self.vol = vol

    @classmethod
    def init(cls, ctx, renderer: str = "exact", volume=None):
        """``renderer``: "exact" (the oracle-parity march kernel), "fast"
        (the shear-warp approximation at intermediate I=512) or "hybrid"
        (the fast frame at I=512 with up to 128 tiles re-marched exactly,
        the JAX package's defaults). ``volume``: the (D, H, W) uint8 or
        float32 volume (an array or a tensor; the exact renderer maps a
        float32 one by its data range, fast and hybrid refuse it), or the
        path of an Open SciVis uint8 or float32 ``.raw`` file
        (:func:`load_open_scivis`); None for the bonsai."""
        if renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {renderer!r}")
        if volume is None:
            vol = get_bonsai()
        elif isinstance(volume, (str, os.PathLike)):
            vol = load_open_scivis(volume)
        else:
            vol = volume
        return cls(RENDERERS[renderer](vol, ctx.device), vol)

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/bonsai/main.rs:68-73
        return Camera.bonsai(aspect)

    def render(self, ctx):
        bb = ctx.render_backbuffer
        img = self.renderer(ctx.camera_uniform, bb.width, bb.height)
        bb.store(img)
