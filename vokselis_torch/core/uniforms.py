"""Per-frame global uniform state (mirrors Uniform, src/context/global_ubo.rs:52-119).

In the reference this is a 48-byte UBO re-uploaded every frame
(src/context/global_ubo.rs:47-49). Here it is a dataclass of small tensors on
the render device, rebuilt by :meth:`GlobalUniform.with_` each frame. Host
values reach a card through :func:`upload`, which never makes the host wait.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


def _count(name: str, n: int = 1) -> None:
    """:func:`vokselis_torch.engine.profiler.count`, which replaces this
    function at its first call: the engine package imports this module, so
    it cannot be imported here at the top, and an import in every upload
    would cost more than the count."""
    global _count
    from vokselis_torch.engine.profiler import count as _count

    _count(name, n)


def upload(x, device, dtype=torch.float32) -> torch.Tensor:
    """Host values (a number, a sequence, a numpy array) as a new tensor of
    ``dtype`` on ``device``, without a synchronizing copy: for a card they
    are staged in pinned memory and copied ``non_blocking``, and the
    caching host allocator keeps the staging block until the copy has run
    (each call stages its own block). Other devices get a plain copy.
    Counted as ``uploads`` and ``upload_bytes`` (:func:`engine.profiler.count`)."""
    device = torch.device(device)
    host = torch.tensor(np.asarray(x), dtype=dtype)
    _count("uploads")
    _count("upload_bytes", host.nbytes)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


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
            return upload(v, device)

        def u32(v):
            return upload(v, device, torch.uint32)

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
        """A copy with the given fields replaced: tensors are taken as they
        are (cast to the field's dtype on this device), host values are
        uploaded without a synchronizing copy (:func:`upload`)."""
        conv = {}
        for k, v in kw.items():
            dtype = torch.uint32 if k in ("frame", "mouse_pressed") else torch.float32
            if isinstance(v, torch.Tensor):
                conv[k] = v.to(device=self.device, dtype=dtype)
            elif dtype == torch.uint32:
                conv[k] = upload(int(v), self.device, dtype)
            else:
                conv[k] = upload(v, self.device, dtype)
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
