"""Driver of the bonsai frame cells: the frame loop (:mod:`benchmark.loop`)
over a ``BonsaiDemo`` on the exact renderer, handed the benchmark's seeded
volume (:mod:`benchmark.reference.standin`).

The orbit turns about the box's centre. A traced run times K1
(``march_bonsai_kernel``) against its bound over the profiled frames'
poses; ``correct`` holds each sampled display image against the
reference's exact march and present of the same pose.
"""

from __future__ import annotations

import torch

from benchmark.loop import FrameLoop
from benchmark.reference import march, present, standin
from benchmark.roofline import bound_s, k1

K1_NAME = "march_bonsai_kernel"
TINY = {"width": 48, "height": 32, "dims": 32}  # the CPU tests' size
# the control's largest error grows with the pixels compared: at 256^2 and 16
# frames it clears the limit on every seed tried (0.036-0.217), at 48x32 not
CONTROL_SIZE = {"width": 256, "height": 256, "dims": 64}


class BonsaiLoop(FrameLoop):
    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        super().__init__(cfg, mix, seed, device)
        self.dims = cfg["dims"]

    def demo(self):
        from vokselis_torch.models.bonsai import BonsaiDemo
        from vokselis_torch.ops.cuda.march_bonsai import BonsaiRenderer

        vol = standin.bonsai(self.dims, self.seed, self.device)

        class SeededBonsai(BonsaiDemo):
            """The bonsai demo on the exact renderer over the seeded volume."""

            @classmethod
            def init(cls, ctx):
                return cls(BonsaiRenderer(vol, ctx.device), vol)

        return SeededBonsai

    def kernels(self) -> dict:
        return {"K1": K1_NAME}

    def _rays(self, frames):
        """The rays of ``frames``, one after another: (eye (N, 3), dirs (N, 3))."""
        eyes, dirs = [], []
        for f, (vp, inv) in sorted(self.poses(frames).items()):
            e, d = march.rays(torch.from_numpy(vp).to(self.device),
                              torch.from_numpy(inv).to(self.device), self.width, self.height)
            eyes.append(e.expand(d.shape))
            dirs.append(d)
        return torch.cat(eyes), torch.cat(dirs)

    def bounds(self, frames) -> dict:
        """Seconds: the sum over ``frames`` of each frame's K1 bound."""
        vol = standin.bonsai(self.dims, self.seed, self.device)
        eye, dirs = self._rays(frames)
        per_frame = march.touched_samples(vol, eye, dirs, march.max_steps(self.dims))
        n_bytes = k1.frame_bytes(self.dims, self.width, self.height)
        return {"K1": sum(bound_s(n_bytes, k1.ops(int(n)))
                          for n in per_frame.reshape(len(frames), -1).sum(dim=1).tolist())}

    def reference_images(self, frames, dtype):
        vol = standin.bonsai(self.dims, self.seed, self.device)
        eye, dirs = self._rays(frames)
        hdr = march.march(vol, eye, dirs, march.max_steps(self.dims), dtype)
        return present.present(hdr).reshape(len(frames), self.height, self.width, 4)

    def control_answers(self) -> list:
        return [(f, None) for f in range(0, 1600, 100)]


def make(cfg: dict, mix: dict, seed: int, device="cuda") -> BonsaiLoop:
    return BonsaiLoop(cfg, mix, seed, device)
