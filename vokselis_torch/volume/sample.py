"""Texture-sampler semantics (wgpu-exact), plain torch.

The reference samples its volumes two ways:

- ``textureSampleLevel(volume, tex_sampler, p, 0.0)`` on an R8Unorm 3D texture
  with a linear-filtering, ClampToEdge sampler (bonsai path,
  shaders/raycast_naive.wgsl:102; sampler src/context/volume_texture.rs:61-66).
  WebGPU linear filtering uses half-texel centers: texel space
  ``x = u*size - 0.5``, the two taps are floor(x) and floor(x)+1, each clamped
  to [0, size-1] (ClampToEdge), lerped by fract(x). Sampling an R8Unorm
  texture as float4 yields ``(r, 0, 0, 1)`` — missing components default to
  0,0,1. That makes the shader's ``pow(tex.a, 2) == 1`` and kills its
  background-bleed term; replicated faithfully.

- ``textureLoad(volume, ivec3)`` nearest/unfiltered on rgba16float storage
  textures (xor path, shaders/raycast_compute.wgsl:70-72). The reference
  compiles with bounds checks disabled (BoundsCheckPolicy::Unchecked,
  src/utils/shader_compiler.rs:89-94) so out-of-range loads are UB there; we
  define them as clamped.
"""

from __future__ import annotations

import torch


def trilinear_weights(p, size):
    """Texel-space decomposition of normalized coords ``p`` (..., 3).

    Returns (i0, frac): integer base taps (..., 3) int64 (clamped on use),
    and lerp fractions (..., 3).
    """
    x = p * size - 0.5
    i0 = torch.floor(x)
    frac = x - i0
    return i0.to(torch.int64), frac


def sample_trilinear_r8(vol, p, value_range=None):
    """``textureSampleLevel`` of an R8Unorm 3D texture at normalized ``p``.

    ``vol``: (D, H, W) tensor, uint8 (dequantized by /255) or float, read
    as it is (already in [0,1]) or, with ``value_range = (lo, inv)``, each
    tap mapped as ``(v - lo) * inv``, two float32 operations, before the
    lerps (a float32 field mapped by its data range). ``p``: (..., 3) with
    components (x, y, z), on ``vol``'s device. Returns the scalar red
    channel (...,); callers needing the full RGBA should treat it as
    ``(r, 0, 0, 1)``.
    """
    d, h, w = vol.shape
    sizes = torch.tensor([w, h, d], dtype=torch.float32, device=vol.device)
    i0, f = trilinear_weights(p, sizes)
    flat = vol.reshape(-1)

    def tap(ix, iy, iz):
        ix = torch.clamp(ix, 0, w - 1)
        iy = torch.clamp(iy, 0, h - 1)
        iz = torch.clamp(iz, 0, d - 1)
        v = flat[(iz * h + iy) * w + ix]
        if vol.dtype == torch.uint8:
            return v.to(torch.float32) * (1.0 / 255.0)
        if value_range is not None:
            return (v.to(torch.float32) - value_range[0]) * value_range[1]
        return v.to(torch.float32)

    ix0, iy0, iz0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    c000 = tap(ix0, iy0, iz0)
    c100 = tap(ix0 + 1, iy0, iz0)
    c010 = tap(ix0, iy0 + 1, iz0)
    c110 = tap(ix0 + 1, iy0 + 1, iz0)
    c001 = tap(ix0, iy0, iz0 + 1)
    c101 = tap(ix0 + 1, iy0, iz0 + 1)
    c011 = tap(ix0, iy0 + 1, iz0 + 1)
    c111 = tap(ix0 + 1, iy0 + 1, iz0 + 1)

    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def sample_nearest(vol, idx):
    """``textureLoad``: unfiltered fetch at integer texel ``idx`` (..., 3)
    = (x, y, z); out-of-range clamped (reference behavior is UB — see module
    docstring). ``vol``: (D, H, W) or (D, H, W, C)."""
    d, h, w = vol.shape[:3]
    ix = torch.clamp(idx[..., 0], 0, w - 1).long()
    iy = torch.clamp(idx[..., 1], 0, h - 1).long()
    iz = torch.clamp(idx[..., 2], 0, d - 1).long()
    return vol[iz, iy, ix]
