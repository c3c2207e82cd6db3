"""The Miranda stand-in, made on the device from a seed.

The configuration marches the Open SciVis "miranda" field (the density of
LLNL's Miranda simulation of Rayleigh-Taylor mixing between two fluids, x
1024, y 1024, z 1024, float32), which the repository does not hold. This is
a field of that shape and of that kind, written down once and not tuned to
the program. In unit-box coordinates (voxel i of an axis of N at i / (N -
1)), with y up (the orbit's axis):

- the interface height h(x, z) = 0.5 + 0.10 (2 m - 1), m a two-octave 2D
  value noise, 0.6 of a 6^2 lattice and 0.4 of a 17^2 one;
- the heavy fraction f = clamp(0.5 + (y - h) / 0.30 + 0.45 (2 n - 1), 0, 1),
  n a two-octave 3D value noise, 0.6 of a 16^3 lattice and 0.4 of a 53^3
  one;
- the density rho = 1 + 2 f in float32, never quantised: the light fluid 1
  below the layer, the heavy fluid 3 above it (Atwood number 0.5), and a
  turbulent band of about 0.3 of the height between them.

Each noise's lattices span the box end to end with smoothstep weights and
are drawn from ``seed`` by a generator on the field's device, m's before
n's, each octave's lattice in the order listed. The field is made in
z-slabs of :data:`SLAB` planes, so that its temporaries stay near 1 GB at
full size. :func:`shares` counts the voxels of each of the three parts.
"""

from __future__ import annotations

import torch

from benchmark.reference.standin_kingsnake import _axis_weights, _lerp_axis

HEIGHT_NOISE = ((0.6, 6), (0.4, 17))  # (amplitude, lattice cells) of m
MIX_NOISE = ((0.6, 16), (0.4, 53))  # of n
H0, H_AMP = 0.5, 0.10
BAND, MIX_AMP = 0.30, 0.45
LIGHT, HEAVY = 1.0, 3.0
SLAB = 16


def _height(d: int, w: int, gen, device):
    """h(x, z) as a (D, 1, W) tensor: the interface's height over each
    (z, x) column."""
    m = 0.0
    for amp, cells in HEIGHT_NOISE:
        g = torch.rand((cells, cells), generator=gen, device=device)  # [z, x]
        g = _lerp_axis(g[:, None, :], 2, _axis_weights(w, cells, device))
        g = _lerp_axis(g, 0, _axis_weights(d, cells, device))
        m = m + amp * g
    return H0 + H_AMP * (2.0 * m - 1.0)


class _Noise:
    """n: its lattices interpolated along x and y once, (cells, H, W) a
    lattice; a slab of z-planes then takes its z interpolation."""

    def __init__(self, shape, gen, device):
        d, h, w = shape
        self.octaves = []
        for amp, cells in MIX_NOISE:
            g = torch.rand((cells, cells, cells), generator=gen, device=device)
            g = _lerp_axis(g, 2, _axis_weights(w, cells, device))
            g = _lerp_axis(g, 1, _axis_weights(h, cells, device))
            self.octaves.append((amp, g, _axis_weights(d, cells, device)))

    def slab(self, z0: int, z1: int):
        out = 0.0
        for amp, g, (i0, i1, f) in self.octaves:
            out = out + amp * _lerp_axis(g, 0, (i0[z0:z1], i1[z0:z1], f[z0:z1]))
        return out


@torch.no_grad()
def miranda(shape, seed: int, device) -> torch.Tensor:
    """The (D, H, W) float32 stand-in [z, y, x] for ``seed``."""
    d, h, w = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    height = _height(d, w, gen, device)
    noise = _Noise(shape, gen, device)
    ys = torch.linspace(0, 1, h, dtype=torch.float32, device=device)[None, :, None]
    out = torch.empty((d, h, w), dtype=torch.float32, device=device)
    for z0 in range(0, d, SLAB):
        z1 = min(z0 + SLAB, d)
        n = noise.slab(z0, z1)
        f = 0.5 + (ys - height[z0:z1]) / BAND + MIX_AMP * (2.0 * n - 1.0)
        out[z0:z1] = LIGHT + (HEAVY - LIGHT) * torch.clamp(f, 0.0, 1.0)
    return out


@torch.no_grad()
def shares(vol) -> dict:
    """The shares of the field's voxels in each part: ``light`` (rho = 1),
    ``heavy`` (rho = 3) and ``mixed`` (between)."""
    n = vol.numel()
    light = int((vol == LIGHT).sum()) / n
    heavy = int((vol == HEAVY).sum()) / n
    return {"light": light, "heavy": heavy, "mixed": 1.0 - light - heavy}
