"""Config 5's time-varying density, plain torch.

A frozen copy of the upstream xor demo's fbm field (shaders/xor.wgsl:18-61)
as BASELINE.json's config 5 regenerates it every batch: at each voxel centre
c = (index - D/2) / D, three octaves of value noise (hash fract(sin(n) *
43758.5453123), smoothstep weights, trilinear mixes) at the lattice
((cx + 1) 32, (cy + 0.1 sin t) 32, (cz + 21) 32), masked by
smoothstep(0.5, 0.25, |c|), stored as uint8 clip(alpha 255 + 0.5, 0, 255).
"""

from __future__ import annotations

import torch

from benchmark.reference import strict_float32

SLAB_VOXELS = 1 << 24


def _hash(n, dtype):
    v = torch.sin(n) * 43758.5453123
    return (v - torch.floor(v)).to(dtype)


def _mix(a, b, t):
    return a + (b - a) * t


def _noise(x, y, z, dtype):
    px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = ((v - p).to(dtype) for v, p in ((x, px), (y, py), (z, pz)))
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    fz = fz * fz * (3.0 - 2.0 * fz)
    n = px + py * 157.0 + 113.0 * pz

    def h(k):
        return _hash(n + k, dtype)

    return _mix(_mix(_mix(h(0.0), h(1.0), fx), _mix(h(157.0), h(158.0), fx), fy),
                _mix(_mix(h(113.0), h(114.0), fx), _mix(h(270.0), h(271.0), fx), fy), fz)


def _alpha(cx, cy, cz, sin_t, dtype):
    x, y, z = (cx + 1.0) * 32.0, (cy + sin_t * 0.1) * 32.0, (cz + 21.0) * 32.0
    f = 0.5 * _noise(x, y, z, dtype)
    x, y, z = x * 2.01, y * 2.01, z * 2.01
    f = f + 0.25 * _noise(x, y, z, dtype)
    x, y, z = x * 2.02, y * 2.02, z * 2.02
    f = f + 0.125 * _noise(x, y, z, dtype)
    r = torch.sqrt(cx * cx + cy * cy + cz * cz).to(dtype)
    m = torch.clamp((r - 0.5) / (0.25 - 0.5), 0.0, 1.0)
    return f * (m * m * (3.0 - 2.0 * m))


@torch.no_grad()
def density_u8(time: float, dims: int, device, dtype=torch.float32):
    """The (D, D, D) uint8 volume [z, y, x] at ``time`` (a float, rounded to
    float32 as the batch's time is), computed in z-slabs. ``dtype`` is the
    precision of the weights, mixes, octave sum and mask; the lattice and
    the hashes stay float32."""
    strict_float32()
    t = torch.full((), time, dtype=torch.float32, device=device)
    sin_t = torch.sin(t * 1.0)
    c = (torch.arange(dims, dtype=torch.float32, device=device) - dims / 2.0) / dims
    out = torch.empty((dims, dims, dims), dtype=torch.uint8, device=device)
    step = max(1, SLAB_VOXELS // (dims * dims))
    for z0 in range(0, dims, step):
        z1 = min(dims, z0 + step)
        shape = (z1 - z0, dims, dims)
        alpha = _alpha(c[None, None, :].expand(shape), c[None, :, None].expand(shape),
                       c[z0:z1, None, None].expand(shape), sin_t, dtype).to(torch.float32)
        out[z0:z1] = torch.clamp(alpha * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return out
