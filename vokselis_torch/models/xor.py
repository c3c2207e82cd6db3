"""Xor demo: compute raymarch of the procedural fbm volume
(examples/xor/main.rs:34-281).

Reference structure rebuilt:

- the volume is 'generated once at init' at time 0 (main.rs:135-146) — here
  the field is evaluated inline by the march at the time frozen at init
  (``gen_time``; :meth:`XorDemo.regenerate` re-freezes it, as the
  reference would re-dispatch XorCompute). The time lives on the device,
  so a frame uploads nothing for it;
- F1 toggles SinglePass/Tile dispatch (main.rs:189-208): the march kernel's
  block shape, 32x8 pixels ('SinglePass') or 32x16 ('Tile'); the frame is
  bitwise the same in both modes;
- the GPU timestamp-query pass timing printed every 100 frames
  (main.rs:120-131,164-187) becomes a :class:`PassTimer` around the march.

On a CUDA context the march is the hand-written kernel K7
(:mod:`vokselis_torch.ops.cuda.march_field`); on a CPU context its plain
version. The pipeline registers its source with the context watcher, as
the reference's pipelines do (examples/bonsai/raycast.rs:137-141): on CUDA
the kernel source ``csrc/march_field.cu`` (and ``fields.cuh``), whose edit
rebuilds K7 with nvcc and rebinds the new library; on the CPU the plain
version's field module ``volume/fields_soa.py``, whose edit re-imports it.
A failed edit keeps the last good kernel.
"""

from __future__ import annotations

from pathlib import Path

import torch

from vokselis_torch.core.camera import Camera
from vokselis_torch.core.compiled import CompiledFrame
from vokselis_torch.engine.demo import Demo
from vokselis_torch.engine.profiler import PassTimer, count
from vokselis_torch.ops.cuda import march_field
from vokselis_torch.ops.cuda.build import load_library
from vokselis_torch.ops.reference import MAX_STEPS_COMPUTE
from vokselis_torch.volume import fields_soa

# block rows of the march kernel in each dispatch mode
MODE_TILE_H = {"SinglePass": 8, "Tile": 16}
# the demo's field, shading and grid (the quantized 256^3 noise volume)
FIELD, SHADING, DIMS = "noise", "xor", 256


class FieldPipeline:
    """The xor demo's compute-march pipeline (ReloadablePipeline protocol):
    the fused noise field with xor shading through
    :func:`march_field.render_field` (K7 on a CUDA device, its plain version
    on the CPU). ``grad`` is the normal source, by default ``VOK_XOR_GRAD``
    ("analytic" or "fd"), and ``dims`` the field's grid, 256 in the demo.

    ``source`` is K7's CUDA source, by default ``csrc/march_field.cu``; another
    one (an edited copy with its headers beside it) is built here, and a
    failed first build raises. ``lib`` is the K7 library the pipeline
    launches (None: the module's own) and ``fields`` the plain version's
    field module; :meth:`reload` rebinds the one of the device's route.

    On a card :meth:`render` replays a CUDA graph of the frame
    (:func:`march_field.field_rays` + K7; ``compiled``), one per width,
    height and ``tile_h`` (the field, shading, normals, quantization, grid
    and step count are the pipeline's), with the time copied into the
    graph's 0-d input: a new time replays. :func:`march_field.render_field`
    is the eager frame. Each call adds its rays, width x height, to the
    counter ``field.rays`` of an active ``profiler.recording()``."""

    def __init__(self, device, grad: str | None = None, source=None, dims: int = DIMS):
        self.device = torch.device(device)
        self.grad = march_field.default_grad() if grad is None else grad
        self.dims = dims
        self.source = march_field.SOURCE if source is None else Path(source)
        self.fields = fields_soa
        self.lib = None
        self.compiled = CompiledFrame("FieldPipeline")
        if self.device.type == "cuda" and source is not None:
            self.lib = march_field.bind(load_library(self.source)[0])

    def register(self, watcher):
        """Watch this pipeline's source: the kernel's on CUDA, the field
        module on the CPU."""
        if self.device.type == "cuda":
            return watcher.register_kernel(self.source, self)
        return watcher.register(self.fields, self)

    def reload(self, module):
        """``module``: a rebuilt K7 library (CUDA) or a re-imported field
        module (CPU). The frames are captured anew, as the JAX package
        re-jits after a reload: a graph keeps the old kernel's function."""
        if self.device.type == "cuda":
            self.lib = march_field.bind(module)
        else:
            self.fields = module
        self.compiled.clear()

    def render(self, camera_uniform, time, width: int, height: int,
               tile_h: int = march_field.DEFAULT_TILE_H):
        """The frame at ``time`` (a Python float or a 0-d tensor on the
        uniform's device)."""
        cuda = self.device.type == "cuda"
        lib, fields = (self.lib, None) if cuda else (None, self.fields)

        def fn(u, t):
            return march_field.render_field(u, t, width, height, field=FIELD, shading=SHADING,
                                            dims=self.dims, max_steps=MAX_STEPS_COMPUTE,
                                            tile_h=tile_h, grad=self.grad, lib=lib,
                                            fields=fields)

        key = (width, height, FIELD, SHADING, self.grad, True, tile_h, self.dims,
               MAX_STEPS_COMPUTE)
        count("field.rays", width * height)
        return self.compiled(key, fn, (camera_uniform, time))


class XorDemo(Demo):
    MODES = tuple(MODE_TILE_H)

    def __init__(self, device, gen_time, grad: str | None = None, source=None,
                 dims: int = DIMS):
        self.mode = "SinglePass"
        self.gen_time = gen_time  # 0-d f32 tensor on the device (main.rs:135-146)
        self.timer = PassTimer("raycast shader", device=device)
        self.pipeline = FieldPipeline(device, grad, source, dims)
        print("Change rendering mode on F1")

    @classmethod
    def init(cls, ctx, grad: str | None = None, source=None):
        """``source``: K7's CUDA source to build and watch (default
        ``csrc/march_field.cu``)."""
        demo = cls(ctx.device, ctx.global_uniform.time.clone(), grad, source)
        # register with the context watcher at construction, like the
        # reference's pipelines (examples/bonsai/raycast.rs:137-141)
        demo.pipeline.register(ctx.watcher)
        return demo

    @staticmethod
    def default_camera(aspect: float) -> Camera:
        # examples/xor/main.rs:270-276
        return Camera.xor(aspect)

    def update_input(self, event):
        if (
            event.get("type") == "key"
            and event.get("key", "").lower() == "f1"
            and event.get("pressed", True)
        ):
            self.mode = "Tile" if self.mode == "SinglePass" else "SinglePass"
            print(f"Switched to: {self.mode}")

    def regenerate(self, ctx):
        """Re-freeze the field's time at the context's current time (the
        reference only generates at init; call per frame for an animated
        field)."""
        self.gen_time = ctx.global_uniform.time.clone()

    def update(self, ctx):
        # the timestamp report every 100 frames happens inside PassTimer
        pass

    def render(self, ctx):
        bb = ctx.render_backbuffer
        with self.timer.measure(n_rays=bb.width * bb.height):
            img = self.pipeline.render(ctx.camera_uniform, self.gen_time, bb.width, bb.height,
                                       tile_h=MODE_TILE_H[self.mode])
        bb.store(img)
