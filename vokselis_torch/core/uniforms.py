"""Per-frame global uniform state (mirrors Uniform, src/context/global_ubo.rs:52-119).

In the reference this is a 48-byte UBO re-uploaded every frame
(src/context/global_ubo.rs:47-49). Here it is a dataclass of small tensors on
the render device, rebuilt by :meth:`GlobalUniform.with_` each frame.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class GlobalUniform:
    pos: torch.Tensor  # (3,) f32 — user-nudged position (src/utils/input.rs:88-110)
    frame: torch.Tensor  # () u32
    resolution: torch.Tensor  # (2,) f32 (width, height)
    mouse: torch.Tensor  # (2,) f32 NDC, y flipped (src/utils/input.rs:64-75)
    mouse_pressed: torch.Tensor  # () u32
    time: torch.Tensor  # () f32 seconds
    time_delta: torch.Tensor  # () f32 seconds

    @classmethod
    def default(cls, device):
        """Default::default() for Uniform (src/context/global_ubo.rs:67-81).

        Keeps the reference's quirky default resolution of (1920, 780); the
        engine overwrites it with the real framebuffer size every frame
        (src/context.rs:226-229).
        """

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        def u32(v):
            return torch.tensor(v, dtype=torch.uint32, device=device)

        return cls(
            pos=f32([0.0, 0.0, 0.0]),
            frame=u32(0),
            resolution=f32([1920.0, 780.0]),
            mouse=f32([0.0, 0.0]),
            mouse_pressed=u32(0),
            time=f32(0.0),
            time_delta=f32(1.0 / 60.0),
        )

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def with_(self, **kw) -> "GlobalUniform":
        conv = {}
        for k, v in kw.items():
            if k in ("frame", "mouse_pressed"):
                conv[k] = torch.tensor(int(v), dtype=torch.uint32, device=self.device)
            else:
                conv[k] = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        return replace(self, **conv)

    def __str__(self):
        # mirrors the Display impl (src/context/global_ubo.rs:121-143)
        return (
            "Global Uniforms:\n"
            f"\tposition:\t{[float(x) for x in self.pos]}\n"
            f"\tframe:\t\t{int(self.frame)}\n"
            f"\tresolution:\t{[float(x) for x in self.resolution]}\n"
            f"\tmouse:\t\t{[float(x) for x in self.mouse]}\n"
            f"\tmouse pressed:\t{bool(int(self.mouse_pressed))}\n"
            f"\ttime:\t\t{float(self.time)}\n"
            f"\ttime delta:\t{float(self.time_delta)}\n"
        )
