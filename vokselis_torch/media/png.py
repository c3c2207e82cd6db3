"""Minimal dependency-free PNG encoder (replaces the reference's ``png`` crate,
src/utils/recorder.rs:189-217).

:func:`write_png` prefers the native C++ encoder
(:mod:`vokselis_torch.native`) when it builds; the encoder here is
stdlib-only (zlib + struct) and writes the same bytes: 8-bit
RGB/RGBA/greyscale, filter 0, one zlib IDAT.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from vokselis_torch import native

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, compress_level: int = 1) -> bytes:
    """Encode (H, W) or (H, W, C) uint8 image to PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG encoder wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {c}")
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * c)
    compressed = zlib.compress(raw.tobytes(), compress_level)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", compressed)
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, compress_level: int = 1,
              backend: str = "auto") -> None:
    """Write ``img`` as a PNG. ``backend``: "native" (the C++ encoder; raises
    if its library cannot be built), "python" (:func:`encode_png`), or
    "auto" (native when the library builds, python otherwise)."""
    if native.use_native(backend):
        native.write_png_native(path, img, compress_level)
        return
    with open(path, "wb") as f:
        f.write(encode_png(img, compress_level))


def read_png(path: str) -> np.ndarray:
    """Tiny PNG reader for golden-image tests (8-bit, non-interlaced,
    greyscale/RGB/RGBA/greyscale+alpha only)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color = interlace = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunk)
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    if bitdepth != 8 or interlace != 0:
        raise ValueError(f"unsupported PNG (bitdepth={bitdepth}, interlace={interlace})")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + stride)
    filters = raw[:, 0]
    lines = raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    bpp = channels
    for y in range(h):
        line = lines[y].copy()
        f = filters[y]
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if f == 0:
            out[y] = line
        elif f == 1:
            for x in range(stride):
                line[x] = (line[x] + (out[y, x - bpp] if x >= bpp else 0)) & 0xFF
                out[y, x] = line[x]
        elif f == 2:
            out[y] = (line + prev) & 0xFF
        elif f == 3:
            for x in range(stride):
                a = out[y, x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((a + prev[x]) >> 1)) & 0xFF
                out[y, x] = line[x]
        elif f == 4:
            for x in range(stride):
                a = out[y, x - bpp] if x >= bpp else 0
                c = prev[x - bpp] if x >= bpp else 0
                b = prev[x]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
                out[y, x] = line[x]
        else:
            raise ValueError(f"bad filter {f}")
    img = out.astype(np.uint8).reshape(h, w, channels)
    if color == 3:
        img = palette[img[:, :, 0]]
    return img
