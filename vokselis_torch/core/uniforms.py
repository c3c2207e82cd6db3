"""Per-frame global uniform state (mirrors Uniform, src/context/global_ubo.rs:52-119).

In the reference this is a 48-byte UBO re-uploaded every frame
(src/context/global_ubo.rs:47-49). Here it is a set of small tensors on the
render device, views of one block of 32-bit words (made when first read),
with a host mirror of those words: :meth:`GlobalUniform.with_` writes a
frame's values into a copy of the mirror and :func:`send` copies the words
to the device in one go, never making the host wait for a copy to finish.
"""

from __future__ import annotations

import numpy as np
import torch

# the global uniform's words: (field, offset, words, uint32)
GLOBAL_LAYOUT = (
    ("pos", 0, 3, False),
    ("frame", 3, 1, True),
    ("resolution", 4, 2, False),
    ("mouse", 6, 2, False),
    ("mouse_pressed", 8, 1, True),
    ("time", 9, 1, False),
    ("time_delta", 10, 1, False),
)
GLOBAL_WORDS = 11
_FIELDS = {f[0]: f for f in GLOBAL_LAYOUT}


def _count(name: str, n: int = 1) -> None:
    """:func:`vokselis_torch.engine.profiler.count`, which replaces this
    function at its first call: the engine package imports this module, so
    it cannot be imported here at the top, and an import in every send
    would cost more than the count."""
    global _count
    from vokselis_torch.engine.profiler import count as _count

    _count(name, n)


def send(parts, device) -> torch.Tensor:
    """One float32 block on ``device`` holding ``parts`` (arrays, or what
    ``np.asarray`` takes) flattened one after another: float32 parts by
    their bits (numpy copies a dtype to itself byte for byte), others cast
    to float32. For a card the words are written through a numpy view into
    a pinned host block and copied ``non_blocking`` (the caching host
    allocator keeps the block until its copy has run), so the host never
    waits; on the CPU the host block is the result. Counted as one of
    ``uploads`` and its bytes as ``upload_bytes`` (:func:`engine.profiler.count`)."""
    device = torch.device(device)
    flat = np.concatenate(parts, axis=None)
    cuda = device.type == "cuda"
    host = torch.empty(flat.size, dtype=torch.float32, pin_memory=cuda)
    host.numpy()[:] = flat
    _count("uploads")
    _count("upload_bytes", host.nbytes)
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=cuda)  # one allocation, one copy


def _field(name: str):
    """A field of :class:`GlobalUniform`: its view of the uniform's block,
    made when first read (a frame whose kernels read no global field makes
    none)."""
    _, o, n, u32 = _FIELDS[name]
    shape, strides = ((n,), (1,)) if n > 1 else ((), ())

    def get(self) -> torch.Tensor:
        t = self._fields.get(name)
        if t is None:
            block = self._block.view(torch.uint32) if u32 else self._block
            t = self._fields[name] = block.as_strided(shape, strides, self._base + o)
        return t

    return property(get)


class GlobalUniform:
    """The global uniform's fields on one device: views of ``block``'s words
    from ``offset`` on, as :data:`GLOBAL_LAYOUT` places them (each one
    ``as_strided``, made when first read), with their host copy ``mirror``."""

    pos = _field("pos")  # (3,) f32 — user-nudged position (src/utils/input.rs:88-110)
    frame = _field("frame")  # () u32
    resolution = _field("resolution")  # (2,) f32 (width, height)
    mouse = _field("mouse")  # (2,) f32 NDC, y flipped (src/utils/input.rs:64-75)
    mouse_pressed = _field("mouse_pressed")  # () u32
    time = _field("time")  # () f32 seconds
    time_delta = _field("time_delta")  # () f32 seconds

    def __init__(self, block, mirror, offset: int = 0):
        self._block, self._base = block, block.storage_offset() + offset
        self.mirror = mirror
        self._fields = {}

    @classmethod
    def default(cls, device):
        """Default::default() for Uniform (src/context/global_ubo.rs:67-81).

        Keeps the reference's quirky default resolution of (1920, 780); the
        engine overwrites it with the real framebuffer size every frame
        (src/context.rs:226-229).
        """
        mirror = np.zeros(GLOBAL_WORDS, np.float32)
        mirror[4:6] = (1920.0, 780.0)
        mirror[10] = 1.0 / 60.0
        return cls(send([mirror], device), mirror)

    @property
    def device(self) -> torch.device:
        return self._block.device

    def host(self, name: str) -> np.ndarray:
        """Field ``name``'s float32 words in the mirror (uint32 fields by
        their bits)."""
        _, o, n, _ = _FIELDS[name]
        return self.mirror[o:o + n]

    def mirrored(self, **kw) -> np.ndarray:
        """The mirror of the copy :meth:`with_` makes: the given fields'
        host values written into a copy of this one's."""
        mirror = self.mirror.copy()
        for k, v in kw.items():
            _, o, n, u32 = _FIELDS[k]
            if u32:
                mirror.view(np.uint32)[o] = int(v)
            else:
                mirror[o:o + n] = v
        return mirror

    def with_(self, **kw) -> "GlobalUniform":
        """A copy with the given fields replaced by host values, whose words
        reach the device as one record (:func:`send`)."""
        mirror = self.mirrored(**kw)
        return GlobalUniform(send([mirror], self.device), mirror)

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
