"""The bonsai stand-in, made on the device from a seed.

The upstream demo marches the Open SciVis "bonsai" CT scan (256^3 uint8),
which the repository does not hold. This is the construction of
``vokselis_torch.volume.io.synthetic_bonsai`` (a pot, a bent tapered trunk,
noise-thresholded foliage in three canopy ellipsoids; 8-15 % of voxels
non-zero), with its three value-noise lattices drawn from ``seed`` by a
generator on the volume's device, so that the same seed gives the same
volume in one call of a few large operations.
"""

from __future__ import annotations

import torch

CANOPIES = ((0.52, 0.68, 0.45, 0.26, 0.14, 0.22),
            (0.38, 0.58, 0.55, 0.16, 0.10, 0.15),
            (0.66, 0.60, 0.52, 0.14, 0.09, 0.13))
NOISE = ((0.55, 10), (0.3, 21), (0.15, 43))  # (amplitude, lattice cells)


def _value_noise(n: int, cells: int, gen, device):
    """A cells^3 lattice of uniform values, smoothstep-interpolated onto an
    n^3 grid that spans it end to end."""
    g = torch.rand((cells, cells, cells), generator=gen, device=device)
    idx = torch.linspace(0, cells - 1, n, dtype=torch.float32, device=device)
    i0 = torch.floor(idx).long()
    f = idx - i0
    i1 = torch.clamp(i0 + 1, max=cells - 1)
    f = f * f * (3 - 2 * f)
    for axis in range(3):
        shape = [-1 if ax == axis else 1 for ax in range(3)]
        g = g.index_select(axis, i0) * (1 - f.reshape(shape)) + g.index_select(axis, i1) * f.reshape(shape)
    return g


@torch.no_grad()
def bonsai(n: int, seed: int, device) -> torch.Tensor:
    """The (n, n, n) uint8 stand-in [z, y, x] (y up) for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lin = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    zs, ys, xs = lin[:, None, None], lin[None, :, None], lin[None, None, :]
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    r_xy = torch.sqrt((xs - 0.5) ** 2 + (zs - 0.5) ** 2)
    pot = (ys < 0.18) & (ys > 0.04) & (r_xy < 0.28 - 0.2 * (0.18 - ys))
    vol = torch.where(pot, 0.55, vol)
    t = torch.clamp((ys - 0.16) / 0.45, 0.0, 1.0)
    cx = 0.5 + 0.12 * torch.sin(3.0 * t) * t
    cz = 0.5 + 0.10 * (torch.cos(2.2 * t) - 1.0) * t
    r_trunk = 0.045 * (1.0 - 0.75 * t)
    trunk = ((xs - cx) ** 2 + (zs - cz) ** 2 < r_trunk ** 2) & (ys >= 0.16) & (ys < 0.62)
    vol = torch.where(trunk, 0.85, vol)
    noise = sum(amp * _value_noise(n, cells, gen, device) for amp, cells in NOISE)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    for ox, oy, oz, rx, ry, rz in CANOPIES:
        mask |= ((xs - ox) / rx) ** 2 + ((ys - oy) / ry) ** 2 + ((zs - oz) / rz) ** 2 < 1.0
    foliage = mask & (noise > 0.48)
    vol = torch.where(foliage, torch.clamp(0.3 + 0.6 * (noise - 0.48) / 0.4, 0.0, 0.95), vol)
    return (vol * 255.0 + 0.5).to(torch.uint8)
