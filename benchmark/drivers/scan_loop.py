"""Driver of the scan frame cell: the bonsai demo's frame loop
(:class:`benchmark.drivers.frame_loop.BonsaiLoop`) over a full-size CT scan
of another shape, (D, H, W) = the configuration's ``shape``, handed to the
exact renderer as the benchmark's seeded stand-in
(:mod:`benchmark.reference.standin_kingsnake`).

The orbit turns about the box's centre; the volume fills the unit box
whatever its shape. A traced run times K1 (``march_bonsai_kernel``) against
its bound over the profiled frames' poses (:mod:`benchmark.roofline.k1_volume`)
and keeps the program's own spans and counters of the whole run
(``engine.profiler.recording()``) as ``rec["program"]``; ``correct`` holds
each sampled display image against the reference's march of the
(D, H, W) volume (:mod:`benchmark.reference.volume_march`) and present of
the same pose.
"""

from __future__ import annotations

import torch

from benchmark.drivers.frame_loop import K1_NAME, BonsaiLoop
from benchmark.loop import FrameLoop
from benchmark.reference import present, standin_kingsnake, volume_march
from benchmark.roofline import bound_s, k1, k1_volume

# the CPU tests' size: no two dims alike, none a multiple of 8
TINY = {"width": 48, "height": 32, "shape": [12, 31, 21]}
# the control's size: the bfloat16 march's error grows with the fog a ray
# crosses before it saturates, ~350 samples at full size; 1024 voxels along x
# and z (a thin y keeps it cheap) read 0.0254 at 64x64 and seed 8 on the CPU,
# over the limit, where 64^3-400^3 volumes read 0.006-0.019
CONTROL_SIZE = {"width": 64, "height": 64, "shape": [1024, 16, 1024]}


class ScanLoop(BonsaiLoop):
    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        FrameLoop.__init__(self, cfg, mix, seed, device)
        self.shape = tuple(cfg["shape"])

    def volume(self):
        return standin_kingsnake.kingsnake(self.shape, self.seed, self.device)

    def demo(self):
        from vokselis_torch.models.bonsai import BonsaiDemo
        from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer

        vol = self.volume()
        if vol.is_cuda:  # built before the renderer's set-up (volume.setup) starts
            torch.cuda.synchronize(vol.device)

        class SeededScan(BonsaiDemo):
            """The bonsai demo on the exact renderer over the seeded scan."""

            @classmethod
            def init(cls, ctx):
                return cls(BonsaiRenderer(vol, ctx.device), vol)

        return SeededScan

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
        return {"K1": K1_NAME}

    def bounds(self, frames) -> dict:
        """Seconds: the sum over ``frames`` of each frame's K1 bound."""
        vol = self.volume()
        eye, dirs = self._rays(frames)
        per_frame = volume_march.touched_samples(vol, eye, dirs,
                                                 volume_march.max_steps(self.shape))
        n_bytes = k1_volume.frame_bytes(self.shape, self.width, self.height)
        return {"K1": sum(bound_s(n_bytes, k1.ops(int(n)))
                          for n in per_frame.reshape(len(frames), -1).sum(dim=1).tolist())}

    def reference_images(self, frames, dtype):
        vol = self.volume()
        eye, dirs = self._rays(frames)
        hdr = volume_march.march(vol, eye, dirs, volume_march.max_steps(self.shape), dtype)
        return present.present(hdr).reshape(len(frames), self.height, self.width, 4)


def make(cfg: dict, mix: dict, seed: int, device="cuda") -> ScanLoop:
    return ScanLoop(cfg, mix, seed, device)
