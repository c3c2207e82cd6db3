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
version. Shader hot reload of the field source (the JAX package's
``FieldPipeline.reload`` through the context watcher) is not ported: the
port's Context has no watcher yet (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

from vokselis_torch.core.camera import Camera
from vokselis_torch.engine.demo import Demo
from vokselis_torch.engine.profiler import PassTimer
from vokselis_torch.ops.cuda import march_field

# block rows of the march kernel in each dispatch mode
MODE_TILE_H = {"SinglePass": 8, "Tile": 16}


class FieldPipeline:
    """The xor demo's compute-march pipeline: the fused noise field with xor
    shading through :func:`march_field.render_field` (K7 on a CUDA device,
    its plain version on the CPU). ``grad`` is the normal source, by default
    ``VOK_XOR_GRAD`` ("analytic" or "fd")."""

    def __init__(self, grad: str | None = None):
        self.grad = march_field.default_grad() if grad is None else grad

    def render(self, camera_uniform, time, width: int, height: int,
               tile_h: int = march_field.DEFAULT_TILE_H):
        return march_field.render_field(camera_uniform, time, width, height, field="noise",
                                        shading="xor", tile_h=tile_h, grad=self.grad)


class XorDemo(Demo):
    MODES = tuple(MODE_TILE_H)

    def __init__(self, device, gen_time, grad: str | None = None):
        self.mode = "SinglePass"
        self.gen_time = gen_time  # 0-d f32 tensor on the device (main.rs:135-146)
        self.timer = PassTimer("raycast shader", device=device)
        self.pipeline = FieldPipeline(grad)
        print("Change rendering mode on F1")

    @classmethod
    def init(cls, ctx, grad: str | None = None):
        return cls(ctx.device, ctx.global_uniform.time.clone(), grad)

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
