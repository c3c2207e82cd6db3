"""The kingsnake stand-in, made on the device from a seed.

The configuration marches the Open SciVis "kingsnake" CT scan (a kingsnake
egg, x 1024, y 1024, z 795, uint8), which the repository does not hold.
This is a volume of that shape and of that kind, written down once and not
tuned to the program. In unit-box coordinates (voxel i of an axis of N at
i / (N - 1)), with r the normalised radius of an ellipsoid about (0.5, 0.5,
0.5) with semi-axes (0.30, 0.44, 0.38) in (x, y, z), long along y:

- air, 0, where r >= 1;
- the shell, 0.30 + 0.10 (n - 0.5), where 0.985 <= r < 1 (the outer 1.5 %
  of the radius: a few voxels, semi-transparent under the bonsai transfer);
- the contents, a faint fog 0.16 + 0.08 (n - 0.5), where r < 0.985 (above
  the march's OCC_CUT, 25 / 255, so no cell of it is skipped; a ray
  saturates after ~350 of its samples);
- the embryo, 0.55 + 0.20 (n - 0.5), inside the contents: a tube of radius
  0.03 about an Archimedean spiral of 2.5 turns in the (y, z) plane through
  the centre, radius 0.04 + 0.18 theta / (5 pi) with z scaled by 0.8 (a
  flattened spiral), the tube's distance taken as the radial one in the
  scaled plane with the offset along x;

n is a two-octave value noise, 0.6 of a 12^3 lattice and 0.4 of a 37^3 one,
each spanning the box end to end with smoothstep weights, its lattices drawn
from ``seed`` by a generator on the volume's device as
:mod:`.standin` draws the bonsai's. Values are quantised as
``uint8(v * 255 + 0.5)``. The volume is made in z-slabs of
:data:`SLAB` planes, so that its temporaries stay near 1 GB at full size.
"""

from __future__ import annotations

import math

import torch

CENTRE = (0.5, 0.5, 0.5)
SEMI_AXES = (0.30, 0.44, 0.38)  # x, y, z
SHELL_R = 0.985
NOISE = ((0.6, 12), (0.4, 37))  # (amplitude, lattice cells)
SPIRAL_R0, SPIRAL_R1, SPIRAL_TURNS, SPIRAL_Z_SCALE, TUBE_R = 0.04, 0.22, 2.5, 0.8, 0.03
SLAB = 16


def _axis_weights(n: int, cells: int, device):
    """The lattice taps (i0, i1) and smoothstep weights of an n-point axis
    spanning ``cells`` lattice points end to end."""
    idx = torch.linspace(0, cells - 1, n, dtype=torch.float32, device=device)
    i0 = torch.floor(idx).long()
    f = idx - i0
    return i0, torch.clamp(i0 + 1, max=cells - 1), f * f * (3 - 2 * f)


def _lerp_axis(g, axis, taps):
    i0, i1, f = taps
    shape = [-1 if ax == axis else 1 for ax in range(3)]
    return (g.index_select(axis, i0) * (1 - f.reshape(shape))
            + g.index_select(axis, i1) * f.reshape(shape))


class _Noise:
    """The noise, its lattices interpolated along x and y once: (cells, H,
    W) a lattice; a slab of z-planes then takes its z interpolation."""

    def __init__(self, shape, gen, device):
        d, h, w = shape
        self.octaves = []
        for amp, cells in NOISE:
            g = torch.rand((cells, cells, cells), generator=gen, device=device)
            g = _lerp_axis(g, 2, _axis_weights(w, cells, device))
            g = _lerp_axis(g, 1, _axis_weights(h, cells, device))
            self.octaves.append((amp, g, _axis_weights(d, cells, device)))

    def slab(self, z0: int, z1: int):
        out = 0.0
        for amp, g, (i0, i1, f) in self.octaves:
            out = out + amp * _lerp_axis(g, 0, (i0[z0:z1], i1[z0:z1], f[z0:z1]))
        return out


def _embryo(xs, ys, zs):
    """The tube about the flattened spiral (the module's construction)."""
    u = ys - CENTRE[1]
    v = (zs - CENTRE[2]) / SPIRAL_Z_SCALE
    rho = torch.sqrt(u * u + v * v)
    phi = torch.remainder(torch.atan2(v, u), 2.0 * math.pi)
    theta_max = 2.0 * math.pi * SPIRAL_TURNS
    pitch = (SPIRAL_R1 - SPIRAL_R0) / theta_max
    dist = torch.full_like(rho, float("inf"))
    for k in range(math.ceil(SPIRAL_TURNS) + 1):
        theta = phi + 2.0 * math.pi * k
        on = theta <= theta_max
        dist = torch.where(on, torch.minimum(dist, torch.abs(rho - (SPIRAL_R0 + pitch * theta))),
                           dist)
    return dist * dist + (xs - CENTRE[0]) ** 2 < TUBE_R * TUBE_R


@torch.no_grad()
def kingsnake(shape, seed: int, device) -> torch.Tensor:
    """The (D, H, W) uint8 stand-in [z, y, x] for ``seed``."""
    d, h, w = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = _Noise(shape, gen, device)
    zs_all = torch.linspace(0, 1, d, dtype=torch.float32, device=device)
    ys = torch.linspace(0, 1, h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.linspace(0, 1, w, dtype=torch.float32, device=device)[None, None, :]
    ax, ay, az = SEMI_AXES
    r_xy = ((xs - CENTRE[0]) / ax) ** 2 + ((ys - CENTRE[1]) / ay) ** 2
    out = torch.empty((d, h, w), dtype=torch.uint8, device=device)
    for z0 in range(0, d, SLAB):
        z1 = min(z0 + SLAB, d)
        zs = zs_all[z0:z1, None, None]
        r = torch.sqrt(r_xy + ((zs - CENTRE[2]) / az) ** 2)
        n = noise.slab(z0, z1) - 0.5
        vol = torch.where(r < 1.0, 0.30 + 0.10 * n, 0.0)
        vol = torch.where(r < SHELL_R, 0.16 + 0.08 * n, vol)
        vol = torch.where((r < SHELL_R) & _embryo(xs, ys, zs), 0.55 + 0.20 * n, vol)
        out[z0:z1] = (vol * 255.0 + 0.5).to(torch.uint8)
    return out
