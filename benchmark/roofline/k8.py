"""K8, config 5's density generator (``gendensity_kernel``): its work.

Bytes: the (D, D, D) uint8 volume written once (and sin t read).

Operations: the field's formula at its least work, as the voxels share it
(the count ``chip_smoke.py`` takes, derived again here from the formula).
Per voxel only what differs from voxel to voxel: the three octaves' z
mixes (9), their amplitudes and sum (5), the radius from per-axis squares
(two adds and a sqrt, 3), the mask's smoothstep (8), alpha (1) and the
quantisation (4): 30. Shared, once per use: each axis coordinate's terms
(its centre 2, lattice 2, square 1, three octaves' floor, fraction and
smoothstep 18, two scalings; 25), each hash fract(sin(n) 43758.5453) (4)
once per lattice point the grid reaches in each octave, the x mixes once per
x, lattice row and lattice plane, the y mixes once per voxel column and
lattice plane (3 a mix).
"""

from __future__ import annotations

import math

import numpy as np

OPS_VOXEL = 30
OPS_AXIS = 25
OPS_HASH = 4
OPS_MIX = 3
OCTAVE_SCALES = (2.01, 2.02, None)


def volume_bytes(dims: int) -> int:
    return dims ** 3 + 4


def _cells(v: np.ndarray) -> list:
    """Each octave's lattice cells that the coordinates ``v`` (float32)
    reach: their floors and floors + 1."""
    out = []
    for scale in OCTAVE_SCALES:
        p = set(np.floor(v).astype(np.int64).tolist())
        out.append(p | {q + 1 for q in p})
        if scale is not None:
            v = (v * np.float32(scale)).astype(np.float32)
    return out


def ops(dims: int, time: float) -> int:
    """The operations of one D^3 volume at ``time``."""
    c = ((np.arange(dims, dtype=np.float32) - np.float32(dims / 2.0))
         / np.float32(dims)).astype(np.float32)
    s = np.float32(math.sin(np.float32(time)))
    f32 = np.float32
    xs = _cells((c + f32(1.0)) * f32(32.0))
    ys = _cells((c + s * f32(0.1)) * f32(32.0))
    zs = _cells((c + f32(21.0)) * f32(32.0))
    total = dims ** 3 * OPS_VOXEL + 3 * dims * OPS_AXIS
    for x, y, z in zip(xs, ys, zs):
        total += (OPS_HASH * len(x) * len(y) * len(z) + OPS_MIX * dims * len(y) * len(z)
                  + OPS_MIX * dims * dims * len(z))
    return total
