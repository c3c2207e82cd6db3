"""Driver of the float field frame cell: the bonsai demo's frame loop
(:class:`benchmark.drivers.scan_loop.ScanLoop`) over a float32 simulation
field of (D, H, W) = the configuration's ``shape``, handed to the exact
renderer as the benchmark's seeded stand-in
(:mod:`benchmark.reference.standin_miranda`), which the renderer maps by
its data range.

A traced run times K1 (``march_bonsai_kernel``) against its bound over the
profiled frames' poses (:mod:`benchmark.roofline.k1_float`: the distinct
voxels the reference's counted samples tap, not the whole field) and keeps
the program's own spans and counters of the whole run as
``rec["program"]``; ``correct`` holds each sampled display image against
the reference's march of the float field mapped by its range
(:mod:`benchmark.reference.float_march`) and present of the same pose.
"""

from __future__ import annotations

from benchmark.drivers.scan_loop import ScanLoop
from benchmark.reference import float_march, present, standin_miranda, volume_march
from benchmark.roofline import bound_s, k1_float

# the CPU tests' size: no two dims alike, none a multiple of 8
TINY = {"width": 48, "height": 32, "shape": [12, 31, 21]}
# the control's size: the field's mixing band at the cell's resolution along
# y, a thin z keeping it cheap on the CPU
CONTROL_SIZE = {"width": 64, "height": 64, "shape": [16, 1024, 1024]}


class FloatScanLoop(ScanLoop):
    def volume(self):
        return standin_miranda.miranda(self.shape, self.seed, self.device)

    def bounds(self, frames) -> dict:
        """Seconds: the sum over ``frames`` of each frame's K1 bound."""
        eye, dirs = self._rays(frames)
        samples, voxels = float_march.frame_work(self.volume(), eye, dirs,
                                                 volume_march.max_steps(self.shape),
                                                 self.width * self.height)
        return {"K1": sum(bound_s(k1_float.frame_bytes(v, self.width, self.height),
                                  k1_float.ops(s))
                          for s, v in zip(samples, voxels))}

    def reference_images(self, frames, dtype):
        eye, dirs = self._rays(frames)
        hdr = float_march.march(self.volume(), eye, dirs, volume_march.max_steps(self.shape),
                                dtype)
        return present.present(hdr).reshape(len(frames), self.height, self.width, 4)


def make(cfg: dict, mix: dict, seed: int, device="cuda") -> FloatScanLoop:
    return FloatScanLoop(cfg, mix, seed, device)
