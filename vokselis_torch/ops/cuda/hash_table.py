"""The fbm lattice hash as a table, shared by the field kernels.

K7 (``march_field.cu``), K9 and K8 (``genvol.cu``) read the fbm field's
lattice hashes hash(n) = fract(sin(n) * 43758.5453123) from one table per
device instead of evaluating ``sinf``: the same values bit for bit, without
sinf's slow reduction of the large arguments of octaves 1 and 2. The table
is filled on the device by the plain version's own :func:`fields_soa.hash_`
over every lattice argument the field can reach (:data:`HASH_RANGES`); a
kernel that meets an argument outside it traps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vokselis_torch.volume import fields_soa

# For c in [-1, 1]^3 and sin t in [-1, 1] the fbm lattice (fields_soa._lattice)
# spans x in [0, 64], y in [-35.2, 35.2], z in [640, 704]; octave o scales it by
# 1, 2.01 and 2.01 * 2.02. Each axis's floor range grows by one lattice cell on
# either side, which covers the fd eps (1e-4 moves a point 0.013 cells at
# most), a sample's rounding past the box and the quantized voxel centres
# (inside [-0.5, 0.5]); the corner offsets add up to 271. So octave o's
# lattice argument n = px + 157 py + 113 pz lies in HASH_RANGES[o]:
# (66397, 85653), (133900, 171555), (270852, 346049), 132111 floats in all.
LATTICE_BOX = ((0.0, 64.0), (-35.2, 35.2), (640.0, 704.0))
OCTAVE_SCALES = (1.0, 2.01, 2.01 * 2.02)
LATTICE_W = (1, 157, 113)
CORNER_MAX = 271


def _hash_ranges():
    ranges = []
    for s in OCTAVE_SCALES:
        lo = sum(w * (math.floor(a * s) - 1) for w, (a, _) in zip(LATTICE_W, LATTICE_BOX))
        hi = sum(w * (math.floor(b * s) + 1) for w, (_, b) in zip(LATTICE_W, LATTICE_BOX))
        ranges.append((lo, hi + CORNER_MAX))
    return tuple(ranges)


HASH_RANGES = _hash_ranges()


class HashTable(NamedTuple):
    """The f32 hash values of every octave, concatenated: octave o's hash(n)
    at ``values[off[o] + n - lo[o]]``; a lattice cell's base n may be at most
    ``lo[o] + last[o]`` (its corners reach n + 271)."""

    values: torch.Tensor
    lo: tuple
    off: tuple
    last: tuple


def build_hash_table(device, ranges=HASH_RANGES) -> HashTable:
    """hash(n) = fract(sin(n) * 43758.5453123) for every integer n of each
    octave's range, computed by the plain version's own
    :func:`fields_soa.hash_` on ``device``: on the card the same libdevice
    sine and float32 arithmetic as the plain versions' hash, so a table read
    is that hash bit for bit. ``ranges`` other than :data:`HASH_RANGES` is a
    test hook (a table cut short, which the kernels must trap on)."""
    parts, off, start = [], [], 0
    for lo, hi in ranges:
        parts.append(fields_soa.hash_(torch.arange(lo, hi + 1, dtype=torch.float32,
                                                   device=device)))
        off.append(start)
        start += hi - lo + 1
    return HashTable(torch.cat(parts), tuple(lo for lo, _ in ranges), tuple(off),
                     tuple(hi - lo - CORNER_MAX for lo, hi in ranges))


_tables: dict = {}


def hash_table(device) -> HashTable:
    """:func:`build_hash_table` of ``device``, built once per device and
    kept (0.53 MB); K7, K9 and K8 share it."""
    device = torch.device(device)
    if device not in _tables:
        _tables[device] = build_hash_table(device)
    return _tables[device]


def table_hash(table: HashTable, octave: int, n):
    """The kernels' table read in plain torch: hash(n) of ``octave`` for the
    integer-valued f32 tensor ``n``. Raises IndexError if an n lies outside
    the octave's range (the kernels trap)."""
    i = n - float(table.lo[octave])
    inside = (i >= 0.0) & (i <= float(table.last[octave] + CORNER_MAX))
    if not bool(inside.all()):
        raise IndexError(f"lattice argument outside octave {octave}'s hash table")
    return table.values[table.off[octave] + i.long()]


def table_args(table: HashTable) -> tuple:
    """The table as a kernel launch takes it: the values' pointer, then lo,
    off and last of each octave."""
    return (table.values.data_ptr(), *table.lo, *table.off, *table.last)
