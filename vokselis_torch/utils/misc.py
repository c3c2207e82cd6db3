"""Small host utilities (mirrors src/utils/mod.rs).

- ``create_folder``: idempotent mkdir (src/utils/mod.rs:20-28)
- ``green_blink``: terminal flash on successful reload (src/utils/mod.rs:30-40)
- ``ContinuousDict``: multimap ``key -> list`` (ContiniousHashMap,
  src/utils/mod.rs:48-89) used by the reload watcher registry
- ``ImageDimensions``: even-dimension + row-padding math
  (ImageDimentions, src/utils/mod.rs:91-118) kept for the video-encoder path
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

COPY_BYTES_PER_ROW_ALIGNMENT = 256  # wgpu constant honored by the reference


def create_folder(name: str) -> None:
    os.makedirs(name, exist_ok=True)


def green_blink() -> None:
    """Flash the terminal green (src/utils/mod.rs:30-40)."""
    if not sys.stderr.isatty():
        return
    sys.stderr.write("\x1b[?5h")
    sys.stderr.flush()
    sys.stderr.write("\x1b[?5l")
    sys.stderr.flush()


class ContinuousDict(dict):
    """Multimap: ``push_value`` appends to a per-key list
    (ContiniousHashMap, src/utils/mod.rs:48-89)."""

    def push_value(self, key, value):
        self.setdefault(key, []).append(value)


@dataclass(frozen=True)
class ImageDimensions:
    """Rounds width/height down to even (video-codec friendliness) and
    computes padded bytes-per-row (src/utils/mod.rs:91-118)."""

    width: int
    height: int
    unpadded_bytes_per_row: int
    padded_bytes_per_row: int

    @classmethod
    def new(cls, width: int, height: int, align: int = COPY_BYTES_PER_ROW_ALIGNMENT):
        height = max(height - height % 2, 0)
        width = max(width - width % 2, 0)
        bytes_per_pixel = 4
        unpadded = width * bytes_per_pixel
        padding = (align - unpadded % align) % align
        return cls(width, height, unpadded, unpadded + padding)

    def linear_size(self) -> int:
        return self.padded_bytes_per_row * self.height
