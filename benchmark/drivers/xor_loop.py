"""Driver of the xor frame cell: the frame loop (:mod:`benchmark.loop`) over
the port's ``XorDemo``, its field frozen at a time drawn from the seed
(:func:`benchmark.reference.field.field_time`).

The orbit turns about (0, 0, 0), upstream's target for this demo. A traced
run times K7 (``march_field_kernel``) against its bound over the profiled
frames' poses, and keeps the program's own spans and counters of the whole
run (``engine.profiler.recording()``) as ``rec["program"]``; ``correct``
holds each sampled display image against the reference's field march and
present of the same pose.
"""

from __future__ import annotations

import torch

from benchmark.loop import FrameLoop
from benchmark.reference import field, present
from benchmark.roofline import bound_s, k7

K7_NAME = "march_field_kernel"
# the CPU tests' size: a 16^3 grid takes steps of at least 1/16 (dt =
# max(1 / (dims |d|), 0.01)), so that a frame of the plain version takes
# well under the tests' 0.3 s window
TINY = {"width": 48, "height": 32, "dims": 16}
# the control's largest error grows with the pixels compared: at 48x32 and 16
# frames it reads 0.026-0.031 on the seeds tried, at 128x72 0.035-0.038
CONTROL_SIZE = {"width": 128, "height": 72}


class XorLoop(FrameLoop):
    target = (0.0, 0.0, 0.0)

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        super().__init__(cfg, mix, seed, device)
        self.dims, self.steps = cfg["dims"], cfg["max_steps"]
        self.grad, self.mode = cfg["grad"], cfg["mode"]
        self.time = field.field_time(seed)

    def demo(self):
        from vokselis_torch.models.xor import DIMS, XorDemo

        t = torch.full((), self.time, dtype=torch.float32, device=self.device)
        grad, mode = self.grad, self.mode
        # the demo's own grid takes no argument, so a program whose demo has
        # no ``dims`` runs the cell too
        grid = {} if self.dims == DIMS else {"dims": self.dims}

        class SeededXor(XorDemo):
            """The xor demo with its field frozen at the seed's time."""

            @classmethod
            def init(cls, ctx):
                demo = cls(ctx.device, t, grad, **grid)
                demo.mode = mode
                demo.pipeline.register(ctx.watcher)
                return demo

        return SeededXor

    def measure(self, seconds: float, trace: bool, t_start: float) -> dict:
        if not (trace and self.device.type == "cuda"):
            return super().measure(seconds, trace, t_start)
        from vokselis_torch.engine import profiler

        with profiler.recording() as r:
            rec = super().measure(seconds, trace, t_start)
        snap = r.snapshot()
        snap["by_frame"] = {key: r.by_id(key) for key in snap["spans"]}
        rec["program"] = snap
        return rec

    def kernels(self) -> dict:
        return {"K7": K7_NAME}

    def _rays(self, frames):
        """The rays of ``frames``, one frame after another (nine flat planes)."""
        planes = [field.rays(torch.from_numpy(inv).to(self.device), self.width, self.height,
                             self.dims)
                  for _, (_, inv) in sorted(self.poses(frames).items())]
        return tuple(torch.cat(p) for p in zip(*planes))

    def bounds(self, frames) -> dict:
        """Seconds: the sum over ``frames`` of each frame's K7 bound."""
        n = field.samples(self._rays(frames), self.time, self.dims, self.steps)
        n_bytes = k7.frame_bytes(self.width, self.height)
        return {"K7": sum(bound_s(n_bytes, k7.ops(int(s)))
                          for s in n.reshape(len(frames), -1).sum(dim=1).tolist())}

    def reference_images(self, frames, dtype):
        hdr = field.march(self._rays(frames), self.time, self.dims, self.steps, self.grad, dtype)
        return present.present(hdr).reshape(len(frames), self.height, self.width, 4)

    def control_answers(self) -> list:
        return [(f, None) for f in range(0, 1600, 100)]


def make(cfg: dict, mix: dict, seed: int, device="cuda") -> XorLoop:
    return XorLoop(cfg, mix, seed, device)
